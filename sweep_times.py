"""Time the sweeps of the checkout in the working directory on one GPU.

Usage, from the root of a checkout of this repository on a machine with
an NVIDIA Hopper GPU and the CUDA toolkit:

    python3 /path/to/sweep_times.py LABEL

It imports ``chip_smoke`` and the port from the working directory, not
from this file's checkout, so one copy of this script times any commit
whose ``chip_smoke.py`` defines the instances it calls. It builds that
checkout's kernels, then prints, each line led by LABEL:
the bench, flagship (stacked and fan-out), safe-learning and 51^4
cart-pole sweeps (``chip_smoke.time_sweep``: CUDA events, median of 10
after warm-up), the safe-learning loop's two steps
(``chip_smoke.loop_step_times``), and kernel 1 at the bench sweep's
inputs by CUDA graphs and as eager calls. No oracle, no check.

Host-bound times move between processes, so compare two commits by
running this from each checkout's root in turns on one card (parent,
change, change, parent) and reading the spread of each side.
"""

import sys

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402
import safe_learning_tpu_torch as st  # noqa: E402
from safe_learning_tpu_torch.ops import gp_kernel  # noqa: E402


def main(label):
    card = cs.phase_device()
    cs.phase_build()
    inst = cs.build_bench_instance(1000)
    lyap = st.Lyapunov(inst["grid"], inst["v"], inst["gp"], inst["lf"],
                       inst["lv"], inst["tau"], inst["policy"],
                       initial_set=inst["initial_set"])
    lyap.update_safe_set()
    for _ in range(3):
        cs.time_sweep(label + " bench", lyap, card)
    gp = lyap.dynamics
    points = lyap._device_points()
    states = cs.concatenate_inputs(points, lyap.policy(points))
    ls = gp.kernel.lengthscales
    inputs = ((states / ls).contiguous(), (gp.X_buf / ls).contiguous(),
              gp.chol_inv, gp.alpha, gp._mask(),
              gp.kernel.variance * gp.scale ** 2)

    def call():
        return gp_kernel.fused_gp_predict(*inputs, kind="rbf",
                                          count=gp.count)

    print("{} kernel 1 at the bench inputs: {!r} ms by CUDA graphs, {!r} "
          "ms eager [{}]".format(label, [cs.graph_ms(call) for _ in range(2)],
                                 [cs.cuda_ms(call) for _ in range(3)], card))
    for route in ("stacked", "fan_out"):
        lyap, _ = cs.build_flagship_instance(route=route)
        lyap.update_safe_set()
        cs.time_sweep(label + " flagship " + route, lyap, card)
    lyap, inst = cs.build_safe_learning_instance(seed=0)
    lyap.update_safe_set()
    cs.time_sweep(label + " safe-learning", lyap, card)
    cs.loop_step_times(card, lyap, inst, label)
    lyap, _ = cs.build_cartpole_instance()
    lyap.update_safe_set()
    cs.time_sweep(label + " cartpole 51^4", lyap, card)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: python3 sweep_times.py LABEL")
    main(sys.argv[1])
