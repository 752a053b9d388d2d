"""Grid sweeps over the runners (``sweep.py``) and the dp x sp sequence-parallel
VAE / VAEflex runners on ``torch.distributed`` ranks (``seqpar.py``, on the
mesh and collectives of ``mesh.py``; ``dryrun.py`` self-certifies them
against one device). The JAX package's run sharding (``train/batching.py``)
has no counterpart: the port's runs are a tensor axis of one launch."""

from .dryrun import dryrun_multichip
from .mesh import make_mesh_2d
from .seqpar import train_vae_dp_sharded, train_vae_flex_dp_sharded
from .sweep import RUNNERS, assemble_mat, expand_grid, point_seed, run_sweep

__all__ = ["RUNNERS", "assemble_mat", "dryrun_multichip", "expand_grid", "make_mesh_2d",
           "point_seed", "run_sweep", "train_vae_dp_sharded", "train_vae_flex_dp_sharded"]
