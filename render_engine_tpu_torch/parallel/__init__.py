"""Several cards: the world sharded by entity and the frame in bands of
tile rows, one band a rank, over ``torch.distributed`` with one process a
card.

Port of ``render_engine_tpu/parallel/``: ``mesh`` (the ranks, the world's
and the image's sharding, the world's rows split and joined), ``step``
(the tick partitioned over the entity axis, each rank stepping its
``capacity / n`` rows), ``render`` (a band a rank through the fused
tiled frame, from the whole world) and ``program`` (the step and the
frame over the mesh as CUDA graphs, the counterpart of the JAX package's
jitted sharded frame).
"""

from render_engine_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    columns,
    gather_world,
    image_sharding,
    make_mesh,
    replicated,
    shard_world,
    world_sharding,
)
from render_engine_tpu_torch.parallel.render import (  # noqa: F401
    gather_image,
    render_frame_band,
    render_frame_sharded,
)
from render_engine_tpu_torch.parallel.step import shard_step  # noqa: F401
from render_engine_tpu_torch.parallel.program import (  # noqa: F401
    GLOO_CUDA_REFUSED,
    ShardedPrograms,
)
