from dnn_inference_engine_tpu_torch.quant.quantize import (  # noqa: F401
    quantize_weights_per_channel,
    quantize_act,
    dequantize,
    calibrate,
    quantize_model_params,
)
