"""Record the JAX package's f32 stage-1 results on the procedural bench batch.

Stage 1 of ``bench.py`` (default-mode monocular reconstruction, heading
probe-multistart) on the 10 procedural-gallop problems padded to 64 frames,
float32, on the host CPU. The PyTorch port's ``chip_smoke.py`` holds its own
run of the same problems against these numbers.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_stage1_reference.py

writes ``tests/data/jax_stage1_f32.json`` (a few KB).
"""
import json
import os
import platform
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cheetah_pose_estimation_tpu.parallel import batch as pbatch  # noqa: E402
from cheetah_pose_estimation_tpu.pipeline import bench_lib  # noqa: E402
from cheetah_pose_estimation_tpu.solver import kinematic as kin  # noqa: E402

N_TRIALS = 10
N_FRAMES = 64
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "jax_stage1_f32.json")


def main():
    trajs = bench_lib.load_reference_trajectories(N_TRIALS)
    fpss = [f for _, _, f in trajs]
    batched, q0b, trials, subject = bench_lib.build_batch(
        max_trials=N_TRIALS, n_frames=N_FRAMES, dtype=jnp.float32)
    fte = kin.KinematicFTE(kin.KinematicConfig(), subject)
    run = pbatch.make_kinematic_multistart(fte)
    t0 = time.time()
    st = run(q0b, batched)
    st.q.block_until_ready()
    seconds = time.time() - t0
    qs = np.asarray(st.q, np.float64)
    rows = bench_lib.score_per_trial(qs, trials, fpss, subject)
    out = {
        "what": "JAX package, bench.py stage 1 (make_kinematic_multistart), "
                "procedural gallops, float32",
        "n_trials": N_TRIALS, "n_frames": N_FRAMES, "dtype": "float32",
        "jax": jax.__version__, "backend": jax.default_backend(),
        "host": platform.machine(),
        "wall_s_first_call_incl_compile": round(seconds, 1),
        "final_cost": [float(c) for c in np.asarray(st.cost)],
        "mpe_mm": [r[0] for r in rows],
        "mpjpe_mm": [r[1] for r in rows],
        "comvel_rmse_ms": [r[2] for r in rows],
    }
    out["mean_mpjpe_mm"] = float(np.mean(out["mpjpe_mm"]))
    out["mean_mpe_mm"] = float(np.mean(out["mpe_mm"]))
    with open(OUT, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("mean_mpe_mm", "mean_mpjpe_mm",
                                          "wall_s_first_call_incl_compile")}))


if __name__ == "__main__":
    main()
