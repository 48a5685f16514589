"""fourierflow_tpu_torch: the PyTorch/CUDA port of fourierflow_tpu.

The layout mirrors the JAX package (``ops/``, ``models/``, ``routines/``,
``builders/``, ``commands/``, ``utils/``) so each module's counterpart is
found under the same path. The port imports ``torch`` and never JAX or the
JAX package; the JAX package stays the reference the port is tested
against.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
with no GPU and no explicit CPU request they raise (see ``device.py``).
The hand-written Hopper kernels live in ``csrc/`` and are built at first
use (``ops/_cuda.py``).
"""

__version__ = "0.1.0"
