"""The parallel path on ``torch.distributed`` (port of
``vae_hmc_tpu.parallel``): meshes, data- and tensor-parallel training,
sharded KMeans restarts, sharded features and row-sharded staging."""
from vae_hmc_tpu_torch.parallel.mesh import (  # noqa: F401
    conv_mm_param_sharding, make_mesh, replicate)
