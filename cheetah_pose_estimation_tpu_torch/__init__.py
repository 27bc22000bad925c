"""cheetah_pose_estimation_tpu_torch — the PyTorch/CUDA port of
``cheetah_pose_estimation_tpu``.

Same subpackage layout and function names as the JAX package, written as
plain functions on batched tensors: every solver-facing array carries an
explicit leading trial axis where the JAX package used ``vmap``. The JAX
package is the reference the port is tested against; this package imports
``torch`` and never ``jax``, and nothing of the JAX package: it keeps its own
copies of the numpy-only tables it needs (``models/params.py``,
``models/noise.py``). Entry points that take a ``device`` run on the current
CUDA device unless given ``device="cpu"``.

Ported so far: default-mode monocular kinematic reconstruction of a batch of
trials (``bench.py`` stage 1), with the banded Cholesky solve of every
Levenberg-Marquardt step as a hand-written CUDA kernel
(``ops/cuda_banded.py``, ``csrc/banded_solve.cu``).
"""

__version__ = "0.1.0"
