"""Pairwise pseudo-measurements (PPMs) of "flick" trials.

Port of ``cheetah_pose_estimation_tpu/data/ppm.py`` (numpy and pickle
only). Per camera and frame, the DLC pairwise head stores a dense
part-to-part offset tensor ``pws``; the pseudo-measurement of marker m from
source part s is ``pose[s] + pws[0, s, m]``. This module reads and writes
that per-frame pickle layout (the same bytes as the JAX package's) and
assembles the W = 3 measurement and weight arrays that the solver's
measurement term takes (it is generic in W).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

from ..models.noise import (DLC_MARKER_INDEX, N_DLC_PARTS, PAIRWISE_GRAPH,
                            measurement_weights)
from ..models.skeleton import MARKERS


def save_ppm_pickle(path: str, pose: np.ndarray, likelihood: np.ndarray,
                    pws: np.ndarray) -> None:
    """Write one camera's pairwise data: ``pose`` (n_frames, P, 2) part
    positions (P = 25 DLC parts), ``likelihood`` (n_frames, P), ``pws``
    (n_frames, P, P, 2) source-to-target offsets, as a list of per-frame
    dicts {"pose": the flat (x, y, likelihood) x P vector, "pws": (1, P, P,
    2)}."""
    frames = []
    for t in range(pose.shape[0]):
        flat = np.concatenate(
            [pose[t], likelihood[t][:, None]], axis=1).reshape(-1)
        frames.append({"pose": flat, "pws": pws[t][None]})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(frames, f)


def load_ppm_pickle(path: str) -> List[Dict]:
    with open(path, "rb") as f:
        return normalize_pw_frames(pickle.load(f))


def _normalize_entry(entry: Dict) -> Dict:
    """One frame's record in the {"pose", "pws"} layout: "pose" the flat
    (x, y, likelihood) x P vector, "pws" the (1, P, P, 2) offsets. Reads
    DLC's full-pickle form (``coordinates``, ``confidence``), the aliases
    ``pairwise``, ``pairwise_predictions`` and ``pws_offsets``, and offsets
    without the leading singleton axis."""
    if "pose" in entry and "pws" in entry \
            and np.asarray(entry["pws"]).ndim == 4:
        return entry
    out = dict(entry)
    if "pose" not in out and "coordinates" in out:
        xy = np.asarray(out["coordinates"], dtype=float).reshape(-1, 2)
        conf = np.asarray(out.get("confidence", np.ones(len(xy))),
                          dtype=float).reshape(-1)
        out["pose"] = np.concatenate([xy, conf[:, None]], axis=1).reshape(-1)
    if "pws" not in out:
        for alias in ("pairwise", "pairwise_predictions", "pws_offsets"):
            if alias in out:
                out["pws"] = np.asarray(out[alias])
                break
    pws = np.asarray(out["pws"])
    if pws.ndim == 3:
        out["pws"] = pws[None]
    return out


def normalize_pw_frames(obj) -> List[Dict]:
    """The pairwise pickle as a list indexed by frame, from any of its
    layouts: a list of per-frame dicts, a dict keyed by integer frame, or a
    dict keyed by DLC's ``"frameNNNN"`` strings (other string keys, such as
    ``"metadata"``, are ignored). A missing frame becomes a zero-likelihood
    placeholder, so the likelihood gate drops it."""
    if isinstance(obj, list):
        return [_normalize_entry(e) for e in obj]
    if not isinstance(obj, dict):
        raise TypeError(f"unsupported pairwise pickle layout: {type(obj)}")
    items = {}
    for k, v in obj.items():
        if isinstance(k, str):
            if not k.startswith("frame"):
                continue
            idx = int(k[len("frame"):])
        else:
            idx = int(k)
        items[idx] = _normalize_entry(v)
    if not items:
        return []
    P = N_DLC_PARTS
    blank = {"pose": np.zeros(3 * P), "pws": np.zeros((1, P, P, 2))}
    return [items.get(i, blank) for i in range(max(items) + 1)]


def assemble_ppm_measurements(base_xy: np.ndarray, base_lik: np.ndarray,
                              pw_frames_per_cam: List[List[Dict]],
                              start_frame: int, n_frames: int,
                              dlc_thresh: float = 0.5,
                              kinetic_dataset: bool = False
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """(meas (N, C, L, 2, 3), weight (N, C, L, 3)) of frames
    ``start_frame`` .. ``start_frame + n_frames`` of the DLC arrays
    ``base_xy`` (F, C, L, 2) and ``base_lik`` (F, C, L). w = 0 is the DLC
    prediction, w = 1, 2 the two pairwise pseudo-measurements; each weight
    is the inflated pixel std's inverse of its row (``measurement_weights(3,
    kinetic_dataset)``), gated on the likelihood of the measurement's
    source part (the marker's own for w = 0)."""
    C = base_xy.shape[1]
    L = len(MARKERS)
    meas = np.zeros((n_frames, C, L, 2, 3))
    weight = np.zeros((n_frames, C, L, 3))
    w_rows = measurement_weights(3, kinetic_dataset)
    meas[..., 0] = np.nan_to_num(base_xy[start_frame:start_frame + n_frames])
    gate0 = base_lik[start_frame:start_frame + n_frames] > dlc_thresh
    weight[..., 0] = w_rows[0][None, None, :] * gate0
    for c in range(C):
        frames = pw_frames_per_cam[c]
        for t in range(n_frames):
            fr = frames[start_frame + t]
            flat = np.asarray(fr["pose"])
            xs, ys, lik = flat[0::3], flat[1::3], flat[2::3]
            pws = np.asarray(fr["pws"])
            for l, m in enumerate(MARKERS):
                tgt = DLC_MARKER_INDEX[m]
                for k, src in enumerate(PAIRWISE_GRAPH[m]):
                    meas[t, c, l, 0, k + 1] = xs[src] + pws[0, src, tgt, 0]
                    meas[t, c, l, 1, k + 1] = ys[src] + pws[0, src, tgt, 1]
                    if lik[src] > dlc_thresh:
                        weight[t, c, l, k + 1] = w_rows[k + 1][l]
    return meas, weight


def synthesize_ppm(markers_px: np.ndarray, likelihood: np.ndarray,
                   noise_px: float = 4.0, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic pairwise data of one camera from the marker pixels
    (n_frames, L, 2) and likelihoods (n_frames, L): (pose (n, P, 2), lik
    (n, P), pws (n, P, P, 2)). The DLC parts that are no skeleton marker
    get NaN poses and zero likelihoods; each marker's offsets from its two
    source parts are the observed deltas plus noise. The random draws are
    the JAX package's, in order and count."""
    rng = np.random.default_rng(seed)
    n = markers_px.shape[0]
    P = N_DLC_PARTS
    pose = np.full((n, P, 2), np.nan)
    lik = np.zeros((n, P))
    for l, m in enumerate(MARKERS):
        idx = DLC_MARKER_INDEX[m]
        pose[:, idx] = markers_px[:, l] + rng.normal(scale=noise_px,
                                                     size=(n, 2))
        lik[:, idx] = likelihood[:, l]
    pws = np.zeros((n, P, P, 2))
    for l, m in enumerate(MARKERS):
        tgt = DLC_MARKER_INDEX[m]
        for src in PAIRWISE_GRAPH[m]:
            delta = markers_px[:, l] - pose[:, src] \
                + rng.normal(scale=noise_px, size=(n, 2))
            pws[:, src, tgt] = delta
    return pose, lik, pws
