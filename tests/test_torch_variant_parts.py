"""The parts harnesses on the CPU: every alternative of kernels 4-7's
float32 bodies (``benchmarks/variant_parts.py``) still applies to
``csrc/gp_predict_variants.cu``, and every alternative of kernels 1-3's
strip body (``benchmarks/strip_parts.py``) to
``csrc/gp_predict_common.cuh`` (each text it changes is there exactly
once), and the modules refuse to time without a card. Their timings run
on the card only."""

import pytest
import torch

from safe_learning_tpu_torch.benchmarks import strip_parts, variant_parts


@pytest.mark.parametrize("name", sorted(variant_parts.ALTERNATIVES))
def test_alternative_applies_to_the_source(name):
    entry, what, changes = variant_parts.ALTERNATIVES[name]
    assert entry in variant_parts.ENTRIES and what
    text = variant_parts.alternative_source(name)
    for old, new in changes:
        assert new in text
    assert entry == "gp_" + name.split("_")[0]


@pytest.mark.parametrize("name", sorted(strip_parts.ALTERNATIVES))
def test_strip_alternative_applies_to_the_header(name):
    kernels, where, what, changes = strip_parts.ALTERNATIVES[name]
    assert set(kernels) <= {1, 3} and where in ("panel", "strip") and what
    text = strip_parts.alternative_header(name)
    for old, new in changes:
        assert new in text


def test_a_text_that_is_not_there_is_refused(monkeypatch):
    monkeypatch.setitem(variant_parts.ALTERNATIVES, "broken",
                        ("gp_expanded", "nothing", [("no such text", "")]))
    with pytest.raises(ValueError, match="exactly once"):
        variant_parts.alternative_source("broken")


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        variant_parts.main([])


def test_an_unknown_name_is_refused():
    with pytest.raises(SystemExit):
        variant_parts.main(["no_such_alternative"])


def test_strip_parts_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        strip_parts.main([])


def test_strip_parts_refuses_an_unknown_name():
    with pytest.raises(SystemExit):
        strip_parts.main(["no_such_alternative"])


@pytest.mark.parametrize("size", [1, 4, 8])
def test_strip_cluster_alternatives_fix_the_cluster_size(size):
    text = strip_parts.alternative_header("cluster_{}".format(size))
    assert "  return n > 0 ? {} : 1;".format(size) in text
    assert strip_parts._CLUSTER not in text


def test_strip_fill_after_moves_the_fill_behind_the_solve():
    text = strip_parts.alternative_header("fill_after")
    assert text.count(strip_parts._FILL) == 1
    assert text.index(strip_parts._SOLVE_END) < text.index(strip_parts._FILL)


@pytest.mark.parametrize("spec", ["parent={}", "{}", "fill_only={}",
                                  "source={}"])
def test_strip_parts_refuses_a_bad_earlier_csrc(tmp_path, spec):
    """``--earlier NAME=DIR``: a directory without the header, a missing
    name, or the name of an alternative or of the source is refused."""
    path = tmp_path / "csrc"
    path.mkdir()
    if not spec.startswith("parent"):
        (path / strip_parts._COMMON).write_text("")
    with pytest.raises(SystemExit):
        strip_parts.main(["--earlier", spec.format(path)])
