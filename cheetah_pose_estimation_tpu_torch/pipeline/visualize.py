"""3D skeleton drawing and animation of saved solutions.

Port of ``cheetah_pose_estimation_tpu/pipeline/visualize.py``: the 17-link
skeleton drawn through its 24 markers (``SKELETON_EDGES``), one pose
(:func:`plot_pose`), a marker trajectory (:func:`animate`: mp4 where ffmpeg
is installed, else a PDF of every 5th frame) and a saved ``fte.pickle``
(:func:`render_trial`), optionally over a second solution. Everything here
needs matplotlib; where it is not installed nothing is written and the
functions return False.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np

from ..models.skeleton import MARKERS
from .results import _pyplot

_M = {name: i for i, name in enumerate(MARKERS)}

# marker-graph edges that trace the skeleton
SKELETON_EDGES = [
    ("nose", "r_eye"), ("nose", "l_eye"), ("r_eye", "neck_base"),
    ("l_eye", "neck_base"), ("neck_base", "spine"), ("spine", "tail_base"),
    ("tail_base", "tail1"), ("tail1", "tail2"),
    ("neck_base", "r_shoulder"), ("r_shoulder", "r_front_knee"),
    ("r_front_knee", "r_front_ankle"), ("r_front_ankle", "r_front_paw"),
    ("neck_base", "l_shoulder"), ("l_shoulder", "l_front_knee"),
    ("l_front_knee", "l_front_ankle"), ("l_front_ankle", "l_front_paw"),
    ("tail_base", "r_hip"), ("r_hip", "r_back_knee"),
    ("r_back_knee", "r_back_ankle"), ("r_back_ankle", "r_back_paw"),
    ("tail_base", "l_hip"), ("l_hip", "l_back_knee"),
    ("l_back_knee", "l_back_ankle"), ("l_back_ankle", "l_back_paw"),
]


def _axes3d(plt, positions: np.ndarray):
    """A figure with 3D axes spanning ``positions`` (..., 3) plus 0.2 m
    (JAX ``visualize.py:37-54``)."""
    fig = plt.figure(figsize=(10, 7), dpi=70)
    ax = fig.add_subplot(projection="3d")
    lo = positions.reshape(-1, 3).min(axis=0)
    hi = positions.reshape(-1, 3).max(axis=0)
    ctr = (lo + hi) / 2
    rng = float((hi - lo).max()) / 2 + 0.2
    ax.set_xlim(ctr[0] - rng, ctr[0] + rng)
    ax.set_ylim(ctr[1] - rng, ctr[1] + rng)
    ax.set_zlim(max(ctr[2] - rng, -0.1), ctr[2] + rng)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    return fig, ax


def _draw_pose(ax, pose: np.ndarray, color: str, label: Optional[str] = None):
    """One (24, 3) pose's skeleton edges and markers on ``ax`` (JAX
    ``visualize.py:57-64``)."""
    for k, (a, b) in enumerate(SKELETON_EDGES):
        p = pose[[_M[a], _M[b]]]
        ax.plot(p[:, 0], p[:, 1], p[:, 2], color=color,
                label=label if k == 0 else None, lw=1.5)
    ax.scatter(pose[:, 0], pose[:, 1], pose[:, 2], color=color, s=6)


def plot_pose(positions: np.ndarray, out_path: str,
              overlay: Optional[np.ndarray] = None,
              labels: Sequence[str] = ("estimate", "reference")) -> bool:
    """One (24, 3) pose (of (N, 24, 3): the first), optionally over a
    second (``overlay``), to ``out_path`` (JAX ``visualize.py:67-80``).
    Returns False, writing nothing, without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return False
    positions = np.asarray(positions)
    fig, ax = _axes3d(plt, positions[None] if positions.ndim == 2
                      else positions)
    _draw_pose(ax, positions if positions.ndim == 2 else positions[0],
               "tab:blue", labels[0])
    if overlay is not None:
        _draw_pose(ax, np.asarray(overlay), "tab:orange", labels[1])
    ax.legend()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return True


def animate(positions: np.ndarray, out_path: str, fps: float = 30.0,
            overlay: Optional[np.ndarray] = None,
            stride: int = 1) -> Union[str, bool]:
    """Every ``stride``-th frame of a (N, 24, 3) marker trajectory,
    optionally over a second, as an mp4 at ``out_path`` where ffmpeg is
    installed, else as a PDF of every 5th of those frames beside it (JAX
    ``visualize.py:83-119``). Returns the path written, or False, writing
    nothing, without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return False
    import matplotlib.animation as manim

    positions = np.asarray(positions)[::stride]
    fig, ax = _axes3d(plt, positions)

    def draw(i):
        for artist in list(ax.lines) + list(ax.collections):
            artist.remove()
        _draw_pose(ax, positions[i], "tab:blue", "estimate")
        if overlay is not None:
            _draw_pose(ax, np.asarray(overlay)[::stride][i], "tab:orange",
                       "reference")
        return []

    anim = manim.FuncAnimation(fig, draw, frames=len(positions))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    try:
        anim.save(out_path, writer=manim.FFMpegWriter(fps=fps))
        written = out_path
    except (FileNotFoundError, RuntimeError):
        from matplotlib.backends.backend_pdf import PdfPages
        written = os.path.splitext(out_path)[0] + ".pdf"
        with PdfPages(written) as pdf:
            for i in range(0, len(positions), 5):
                draw(i)
                pdf.savefig(fig)
    plt.close(fig)
    return written


def render_trial(fte_pickle_path: str, out_path: Optional[str] = None,
                 reference_pickle_path: Optional[str] = None,
                 fps: float = 30.0) -> Union[str, bool]:
    """:func:`animate` of a saved ``fte.pickle``'s markers, optionally over
    another solution's on their common frames, to ``out_path``
    (``animation.mp4`` beside the pickle by default) (JAX
    ``visualize.py:122-137``). Returns the path written, or False without
    matplotlib."""
    from ..data.io import load_fte_pickle

    d = load_fte_pickle(fte_pickle_path)
    overlay = None
    if reference_pickle_path:
        overlay = load_fte_pickle(reference_pickle_path)["positions"]
        overlay = overlay[:min(len(overlay), len(d["positions"]))]
    out = out_path or os.path.join(os.path.dirname(fte_pickle_path),
                                   "animation.mp4")
    return animate(d["positions"], out, fps=fps, overlay=overlay)
