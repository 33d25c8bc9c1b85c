"""PyTorch/CUDA port of the quantized CNN inference engine.

The JAX package ``dnn_inference_engine_tpu`` is the reference this port
is held against; this package imports neither it nor JAX. Its layout
follows the JAX package module by module; the TPU kernels become
hand-written CUDA kernels for Hopper (``csrc/``), each beside a plain
PyTorch version that the CPU path runs.
"""

__version__ = "0.1.0"

from dnn_inference_engine_tpu_torch.config import EngineConfig  # noqa: F401
