"""trex_tpu_torch — the PyTorch / CUDA port of ``trex_tpu`` for NVIDIA Hopper.

The package mirrors ``trex_tpu``'s layout module for module, so the
counterpart of ``trex_tpu/ops/spr_scan.py`` is ``trex_tpu_torch/ops/spr_scan.py``.
It imports ``torch`` and numpy only: nothing of JAX and nothing of
``trex_tpu``. Plain tensor code is PyTorch; each Pallas kernel of the JAX
package on the ported path is a CUDA C++ kernel under ``csrc/``, built with
``nvcc`` at first use and bound with ``ctypes`` (``ops/_nvcc.py``), with a
plain PyTorch version of the same function beside its wrapper.

Entry points run on ``cuda`` unless the caller asks for the CPU; tensor
functions follow their inputs' device. Asking for ``cuda`` on a machine
without a card raises.
"""

from trex_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
