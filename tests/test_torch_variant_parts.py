"""``benchmarks/variant_parts.py`` on the CPU: every alternative of kernels
4-7's float32 bodies still applies to ``csrc/gp_predict_variants.cu``
(each text it changes is there exactly once), and the module refuses to
time without a card. Its timings run on the card only."""

import pytest
import torch

from safe_learning_tpu_torch.benchmarks import variant_parts


@pytest.mark.parametrize("name", sorted(variant_parts.ALTERNATIVES))
def test_alternative_applies_to_the_source(name):
    entry, what, changes = variant_parts.ALTERNATIVES[name]
    assert entry in variant_parts.ENTRIES and what
    text = variant_parts.alternative_source(name)
    for old, new in changes:
        assert new in text
    assert entry == "gp_" + name.split("_")[0]


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
