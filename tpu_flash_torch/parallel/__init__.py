from tpu_flash_torch.parallel.mesh import make_mesh
from tpu_flash_torch.parallel.ring import merge_partials, ring_attention, ring_dense_fa
from tpu_flash_torch.parallel.ulysses import ulysses_attention, ulysses_fa
