"""Several cards: the frame in bands of tile rows, one band a rank, over
``torch.distributed`` with one process a card.

Port of ``render_engine_tpu/parallel/``: ``mesh`` (the ranks, the world's
and the image's sharding, the world's rows split and joined) and
``render`` (a band a rank through the fused tiled frame). Every rank holds
the whole world and steps it alike; only the bands are gathered.
"""

from render_engine_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
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
