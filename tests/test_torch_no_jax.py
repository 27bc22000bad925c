"""The PyTorch port runs without JAX or pandas: in a fresh interpreter,
import the port, build and solve a 2-trial 16-frame problem on the CPU,
then check ``sys.modules``. Of the JAX package only the numpy-only tables
``models.params`` and ``models.noise`` (and the empty package modules
around them) may be loaded."""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from cheetah_pose_estimation_tpu_torch.data import synthetic as syn
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin
    datas, q0s = [], []
    for i in range(2):
        d, q0, _ = bench_lib.build_monocular_problem(
            syn.gallop_trajectory(16, seed=i), "acinoset", 120.0, seed=i)
        datas.append(d)
        q0s.append(q0)
    batched, q0b = pbatch.pad_and_stack(datas, q0s, device="cpu")
    from cheetah_pose_estimation_tpu.models import params
    fte = kin.KinematicFTE(kin.KinematicConfig(),
                           params.get_subject("acinoset"))
    probe = fte.make_solver(stages=((10.0, 2),), driver="fixed")
    full = fte.make_solver(stages=((3.0, 2), (1.0, 2)))
    st = pbatch.make_multistart_probe(probe, full)(q0b, batched)
    assert st.q.shape == (2, 16, 54) and torch.isfinite(st.cost).all()
    allowed = {"cheetah_pose_estimation_tpu",
               "cheetah_pose_estimation_tpu.models",
               "cheetah_pose_estimation_tpu.models.params",
               "cheetah_pose_estimation_tpu.models.noise"}
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "pandas")
                 or (m.split(".")[0] == "cheetah_pose_estimation_tpu"
                     and m not in allowed))
    print("FORBIDDEN", bad)
    assert not bad, bad
""")


def test_port_imports_no_jax_pandas_or_jax_package():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FORBIDDEN []" in proc.stdout
