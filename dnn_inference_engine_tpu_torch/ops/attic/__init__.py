"""Non-production kernels, kept for A/B against the production tiers.

Counterpart of ``dnn_inference_engine_tpu/ops/attic/``: there these are
the kernels that lost their A/B on the TPU and are wired to no default
plan. Each has a Hopper port here, a wrapper beside its plain PyTorch
version:

- ``stage0``: ``stage0_fused`` (v1) and ``stage0_fused_v2``, the fused
  stage 0 (quantize + conv1 + 2x2/s2 pool + fold-2 emit). The plan kind
  ``s0``, given in a strategy file at layer 0 of the 416 px YOLOv2-tiny,
  runs ``stage0_fused_v2``; ``stage0_fused`` is reached through its own
  entry only. On the card both wrappers launch one kernel,
  ``csrc/stage0_fused.cu``.
- ``tail``: ``conv3x3_bt`` (``csrc/conv3x3_bt.cu``) and its W8A8 entry
  ``conv2d_w8a8_bt``, the batch-folded tap-shift 3x3 conv of the small
  tail layers. It is not a plan kind, in the JAX package or here.
"""
