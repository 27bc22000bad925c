"""Batched reconstruction over a trial mesh on the PyTorch port: the
counterpart of ``examples/sharded_batch.py``, importing only
``cheetah_pose_estimation_tpu_torch``.

Whole trials are padded and stacked into one batch, split over a 1-D mesh
of devices (contiguous chunks of trials, one per device,
``parallel/batch.shard_batch``) and solved on every device at once, one
host thread per device (``parallel/batch.on_mesh``); each trial's
block-banded system stays on its device, so nothing but the results crosses
between them. The mesh is the CUDA cards (all of them, or the first
``--devices``); ``--cpu`` makes it ``--devices`` entries of the CPU:

    python examples/sharded_batch_torch.py [--devices N] [--trials 8]
        [--frames 32] [--cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cheetah_pose_estimation_tpu_torch.data import synthetic as syn  # noqa
from cheetah_pose_estimation_tpu_torch.models import params as params_mod
from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib  # noqa
from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

# the schedule stage whose first LM step is compared across meshes: the
# final scale, where the robust loss takes real steps in float32
FIRST_STEP = ((1.0, 1),)


def build(trials: int, frames: int, device):
    """``trials`` procedural gallops of ``frames`` frames, each seen by
    camera 2 of 6 fisheye cameras, stacked on ``device``: (batched, q0b,
    the synthetic trials)."""
    datas, q0s, trs = [], [], []
    for i in range(trials):
        q_gt = syn.gallop_trajectory(n_frames=frames, seed=i)
        d, q0, tr = bench_lib.build_monocular_problem(
            q_gt, "acinoset", 120.0, seed=i, n_cams=6, cam_idx=2)
        datas.append(d)
        q0s.append(q0)
        trs.append(tr)
    batched, q0b = pbatch.pad_and_stack(datas, q0s, n_frames=frames,
                                        device=device)
    return batched, q0b, trs


def run(devices=None, trials: int = 8, frames: int = 32, cpu: bool = False,
        mesh=None, warmup: bool = True, verbose: bool = True) -> dict:
    """Solve the batch over the mesh (``mesh``, else the first ``devices``
    CUDA cards, or ``devices`` CPU entries with ``cpu``; never more entries
    than trials): one LM step at the final scale from q0 (its per-trial
    costs), then the default solve, timed (after an untimed warm-up solve
    unless ``warmup`` is False), and the per-trial MPE against the
    synthetic truth."""
    if mesh is None:
        if cpu:
            mesh = pbatch.trial_mesh(devices=["cpu"] * (devices or 8))
        else:
            mesh = pbatch.trial_mesh(devices)
    mesh = pbatch.trial_mesh(min(len(mesh), trials), devices=mesh)
    subject = params_mod.get_subject("acinoset")
    batched, q0b, trs = build(trials, frames, mesh[0])
    fte = kin.KinematicFTE(kin.KinematicConfig(), subject)
    step = pbatch.on_mesh(fte.make_solver(stages=FIRST_STEP), mesh)
    first_cost = step(q0b, batched).cost
    solve = pbatch.on_mesh(fte.make_solver(), mesh)
    if warmup:
        solve(q0b, batched)
    sync = lambda: [torch.cuda.synchronize(d) for d in mesh
                    if d.type == "cuda"]
    sync()
    t0 = time.perf_counter()
    st = solve(q0b, batched)
    sync()
    dt = time.perf_counter() - t0
    qs = st.q.double().cpu().numpy()
    mpes = [float(np.linalg.norm(syn.fk_markers_np(qs[i, :tr.q_gt.shape[0]],
                                                    subject)
                                 - tr.markers_gt, axis=2).mean() * 1e3)
            for i, tr in enumerate(trs)]
    out = {"mesh": [str(d) for d in mesh], "ms": dt * 1e3,
           "first_cost": first_cost.double().cpu().tolist(),
           "cost": st.cost.double().cpu().tolist(), "mpe_mm": mpes,
           "steps": st.it.cpu().tolist()}
    if verbose:
        print(f"mesh: {out['mesh']}; {trials} trials of {frames} frames, "
              f"{trials // len(mesh)} per device")
        print(f"{trials} trials on {len(mesh)} device(s): {dt * 1e3:.0f} "
              f"ms, mean monocular MPE {np.mean(mpes):.0f} mm")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size (default: every CUDA card; 8 with "
                         "--cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="a mesh of --devices entries of the CPU")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--frames", type=int, default=32)
    args = ap.parse_args(argv)
    run(args.devices, args.trials, args.frames, args.cpu)


if __name__ == "__main__":
    main()
