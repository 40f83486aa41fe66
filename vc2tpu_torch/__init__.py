"""vc2tpu_torch — the VC-2 (SMPTE ST 2042-1) codec on PyTorch and CUDA.

A port of ``vc2tpu`` to an NVIDIA Hopper GPU. It decodes HQ and LD
streams from stream bytes to planar output bytes, and encodes HQ (ConstQ
and CBR) and LD pictures from planar samples to stream bytes:

* the host walks the stream syntax and, in native code (``csrc/hq_scan.cpp``
  and ``csrc/ld_scan.cpp``, built with the host C++ compiler), the HQ
  slice chain and the LD slice headers (and, for the encoder's Decoded
  output and a decode on the CPU, the LL recurrence);
* a picture's compressed payload, or its samples, go to the device in one
  copy; its output bytes come back in one;
* the exp-Golomb unpacks, the slice packs, the HQ CBR and LD rate controls,
  the LD LL band's DC prediction and each lifting level are CUDA kernels
  written for ``sm_90a``
  (``csrc/``), built with ``nvcc`` at first use (``core/build.py``);
* quantisation, layout and output formatting are torch ops.

Every kernel wrapper takes its plain PyTorch version for a CPU tensor, so
the whole path runs on the CPU for tests (``device="cpu"``). Entry points
default to the card and raise without one.

This package imports torch and numpy, never jax and nothing of ``vc2tpu``.
"""

from vc2tpu_torch.core.config import (  # noqa: F401
    ColourFormat,
    DecOutput,
    WaveletKernel,
)

__version__ = "0.1.0"


def __getattr__(name):  # lazy top-level API (keeps bare import light)
    if name == "Decoder":
        from vc2tpu_torch.cli.decode_stream import Decoder
        return Decoder
    if name == "Encoder":
        from vc2tpu_torch.pipeline.encoder import Encoder
        return Encoder
    raise AttributeError(name)
