"""The port's counterparts of the JAX repo's ``tools/`` experiments that
run TPU kernels, under the same module names:

- ``probe_dma_rules``: which boxes the copy engine (TMA) accepts for an
  int8 tensor, held against the documented rules (``csrc/tma_probe.cu``);
- ``proto_conv_dma``: the 3x3 int8 conv whose im2col matrix the copy
  engine assembles, with the pool-major group-max (``csrc/conv_dma.cu``).

Run each as ``python -m dnn_inference_engine_tpu_torch.tools.<name>``; on
the card unless given ``--device cpu``.
"""
