"""Multi-device: the (data, model) mesh of ranks on torch.distributed
(mesh.py), the sharding policies (sharding.py), the channel-sharded W8A8
forward (shard_map_forward.py) and the Engine's sharded detect
(sharded_engine.py). Counterpart of ``dnn_inference_engine_tpu/parallel``.
"""

from dnn_inference_engine_tpu_torch.parallel.mesh import (  # noqa: F401
    init_distributed, make_mesh,
)
from dnn_inference_engine_tpu_torch.parallel.sharding import (  # noqa: F401
    input_sharding, make_sharded_forward, shard_params,
)
