"""Grid sweeps over the runners (``sweep.py``), the ranks' mesh and its
collectives (``mesh.py``: ``run_mesh``, the runs mesh whose ranks split a
runner's independent runs, ``train/batching.py``; ``make_mesh_2d``, the
dp x sp mesh) and the dp x sp sequence-parallel VAE / VAEflex runners on
``torch.distributed`` ranks (``seqpar.py``; ``dryrun.py`` self-certifies
them against one device)."""

from .dryrun import dryrun_multichip
from .mesh import make_mesh_2d, run_mesh
from .seqpar import train_vae_dp_sharded, train_vae_flex_dp_sharded
from .sweep import RUNNERS, assemble_mat, expand_grid, point_seed, run_sweep

__all__ = ["RUNNERS", "assemble_mat", "dryrun_multichip", "expand_grid", "make_mesh_2d",
           "point_seed", "run_mesh", "run_sweep", "train_vae_dp_sharded",
           "train_vae_flex_dp_sharded"]
