"""The plain reference against hand-worked instances and against the port
at small sizes on the CPU. (The tests may import the port; the reference
may not.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference import certify, dynamics, gp, judge
from portbench.reference.models import cartpole_51x4, pendulum_adaptive
from portbench.registry import Cell

from .conftest import ROOT, load


def test_expm_and_dlqr_against_scipy():
    import scipy.linalg

    rng = np.random.default_rng(0)
    m = rng.normal(size=(5, 5)) * 0.3
    np.testing.assert_allclose(dynamics.expm(m), scipy.linalg.expm(m),
                               rtol=1e-12, atol=1e-13)
    a = np.array([[1.0, 0.01], [0.2, 0.99]])
    b = np.array([[0.0], [0.01]])
    q, r = np.diag([1.0, 2.0]), np.array([[1.2]])
    k, p = dynamics.dlqr(a, b, q, r)
    p_ref = scipy.linalg.solve_discrete_are(a, b, q, r)
    np.testing.assert_allclose(p, p_ref, rtol=1e-9)


@pytest.mark.parametrize("name", ["pendulum_adaptive", "cartpole_51x4"])
def test_true_system_and_design_match_the_port(name):
    import safe_learning_tpu_torch as st

    cfg = load(ROOT, "configs", name + ".json")
    module = {"pendulum_adaptive": pendulum_adaptive,
              "cartpole_51x4": cartpole_51x4}[name]
    system = module.true_system(cfg)
    if name == "pendulum_adaptive":
        params = cfg["true_params"]
        port = st.InvertedPendulum(params["mass"], params["length"],
                                   params["friction"], cfg["dt"],
                                   normalization=(cfg["state_scale"],
                                                  cfg["action_scale"]))
    else:
        params = cfg["true_params"]
        port = st.CartPole(params["pendulum_mass"], params["cart_mass"],
                           params["length"], params["rot_friction"],
                           cfg["dt"], normalization=(cfg["state_scale"],
                                                     cfg["action_scale"]))
    n = system.state_dim
    z = np.random.default_rng(1).uniform(-1, 1, size=(64, n + 1))
    ours = system(z[:, :n], z[:, n:])
    theirs = port(z[:, :n].astype(np.float32),
                  z[:, n:].astype(np.float32)).cpu().numpy()
    np.testing.assert_allclose(ours, theirs, rtol=2e-5, atol=2e-6)
    a, b = system.linearize()
    a_port, b_port = port.linearize()
    np.testing.assert_allclose(a, a_port, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b, b_port, rtol=1e-5, atol=1e-6)
    d = module.design(cfg)
    k_port, p_port = st.utils.dlqr(a_port, b_port, np.diag(cfg["lqr_q"]),
                                   np.diag(cfg["lqr_r"]))
    np.testing.assert_allclose(d["k"], k_port, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(d["p"], p_port / np.abs(p_port).max(),
                               rtol=1e-4, atol=1e-6)


def test_gp_posterior_hand_worked():
    """One datum, linear kernel ``k(x, z) = x z`` in 1-D, noise s2: the
    posterior at q is mean ``q x y / (x^2 + s2)``, variance ``q^2 - q^2
    x^2 / (x^2 + s2)``."""
    x, y, s2 = 2.0, 3.0, 0.5
    group = gp.GPGroup(gp.Linear([1.0], [0]), s2, 1.0, [0], [[0.0]])
    model = gp.GP([group], [[x]], [[y]], gp.Precision("float64"))
    q = torch.tensor([[0.5], [-1.5]], dtype=torch.float64)
    mean, err = model.evaluate(q)
    qv = q[:, 0].numpy()
    np.testing.assert_allclose(mean[:, 0].numpy(), qv * x * y / (x * x + s2),
                               rtol=1e-14)
    var = qv ** 2 - qv ** 2 * x * x / (x * x + s2)
    np.testing.assert_allclose(err[:, 0].numpy(), np.sqrt(var), rtol=1e-14)


def _one_d_model(tau, refinement, sweep):
    """``x' = x + u``, ``u = -0.1 x``, ``v = x^2`` on the 1-D grid (-1, 0,
    1) with ``L_v = 0.3``, ``L_f = 0.4``: a GP of no data with a
    negligible covariance and the linear prior mean."""
    prec = gp.Precision("float64")
    group = gp.GPGroup(gp.Linear([1e-30], [0]), 1.0, 1.0, [0], [[1.0, 1.0]])
    return certify.Model([[-1.0, 1.0]], [3], [[1.0]], [[0.1]], (-1, 1),
                         ("scalar", 0.3), 0.4, tau,
                         gp.GP([group], np.zeros((0, 2)), np.zeros((0, 1)),
                               prec), prec, refinement, sweep)


def test_certify_hand_worked():
    """At ``x = +-1`` the decrease is ``0.81 - 1 = -0.19`` against the
    threshold ``-0.3 * 1.4 * tau``: it fails at ``tau = 0.5`` (-0.21) and
    passes at ``tau = 0``. The refined check (R = 3, sub-points at ``x``
    and ``x +- 1/3``, threshold ``-0.07``) rescues it: ``-0.19 x^2`` is
    below -0.07 at ``x = 2/3`` (-0.0844)."""
    initial = np.array([False, True, False])
    safe, c_max, levels = certify.certify(_one_d_model(0.5, 1, "fused"),
                                          initial)
    assert safe.tolist() == [False, True, False]
    assert c_max == 0.0
    safe, c_max, levels = certify.certify(_one_d_model(0.0, 1, "fused"),
                                          initial)
    assert safe.all() and c_max == 1.0 and levels.tolist() == [1, 1, 1]
    model = _one_d_model(0.5, 3, "sorted")
    safe, c_max, levels = certify.certify(model, initial)
    assert safe.all() and c_max == 1.0 and levels.tolist() == [3, 1, 3]
    np.testing.assert_allclose(model.refined(np.array([0, 2])),
                               [-0.19 * 4 / 9 + 0.07] * 2, atol=1e-6)


def test_tf32_rounding_keeps_ten_bits():
    x = torch.randn(1000, dtype=torch.float32)
    r = gp.round_tf32(x)
    bits = r.view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11


def _port_outputs(lyap, kwargs):
    lyap.update_safe_set(**kwargs)
    return dict(safe=np.asarray(lyap.safe_set), c_max=lyap.c_max,
                levels=lyap._refinement,
                values=lyap.values.double().cpu().numpy())


@pytest.mark.parametrize("cell", ["adaptive.tiny", "cartpole.tiny"])
def test_reference_against_the_port(tiny_tree, cell):
    """The port's certify at a small size on the CPU, judged by the
    reference, and the reference's own certify: the same safe set and
    c_max, the GP's posterior within float32 rounding."""
    from portbench.traffic import Traffic

    path, bench = tiny_tree
    c = Cell(cell, benchmark=bench, root=path)
    cfg = c.config
    reference, program = c.module("reference"), c.module("program")
    traffic = Traffic(cfg, c.workload, reference, 7)
    points = certify.grid_points(cfg["grid_limits"], [cfg["grid_points"]]
                                 * len(cfg["grid_limits"]))
    initial = reference.initial_set(cfg, points)
    x, y = traffic.base_x, traffic.base_y
    lyap = program.build(cfg, x.astype(np.float32), y.astype(np.float32),
                         initial)
    kwargs = dict(can_shrink=cfg["can_shrink"],
                  max_refinement=cfg["max_refinement"])
    previous = None if cfg["can_shrink"] else initial.copy()
    outputs = _port_outputs(lyap, kwargs)
    model = reference.model(cfg, x, y, gp.Precision("float64"))
    gaps = judge.certify_gaps(model, outputs, initial, previous)
    assert gaps["verdict_gap"] == 0.0
    assert gaps["cut_gap"] < 1e-5 and gaps["cmax_gap"] < 1e-5

    def evaluate(z):
        return lyap.dynamics.evaluate(torch.as_tensor(z))

    assert judge.posterior_gap(model, evaluate) < 1e-4
    safe, c_max, _ = certify.certify(model, initial, previous)
    assert np.array_equal(safe, outputs["safe"])
    assert abs(c_max - outputs["c_max"]) <= 1e-5 * abs(c_max)
    assert 0.02 < outputs["safe"].mean() < 0.98 or cell == "cartpole.tiny"
