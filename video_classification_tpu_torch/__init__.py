"""PyTorch + CUDA port of ``video_classification_tpu`` for NVIDIA Hopper.

The serving path of the JAX package (raw frames -> optical flow -> body-part
crops -> SlowFast scores), with the two Pallas kernels on that path rewritten
as CUDA C++ for ``sm_90a`` (``csrc/``). Module layout and names mirror the JAX
package so each counterpart is easy to find. Entry points run on CUDA unless
the caller passes ``device="cpu"``; on CPU tensors every kernel wrapper runs
its plain PyTorch twin.
"""

__version__ = "0.1.0"
