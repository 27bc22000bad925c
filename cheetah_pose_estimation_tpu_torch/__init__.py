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

Ported so far: monocular reconstruction of a batch of trials in the
default mode (``bench.py`` stage 1), the data-driven mode (stage 1.5) and
the physics-based mode (stage 2), with the banded Cholesky solve of every
Levenberg-Marquardt step as a hand-written CUDA kernel
(``ops/cuda_banded.py``, ``csrc/banded_solve.cu``).
"""

__version__ = "0.1.0"
