"""Parallelism layer: mesh construction, sharding rules, pjit helpers.

The reference's only parallelism is DDP data-parallel over NCCL
(/root/reference/requirements.txt:1,75; SURVEY.md C19/C20). Here there is
no user-space comm code: we lay out a ('data', 'fsdp', 'model') mesh,
annotate shardings, and XLA inserts the collectives (psum/all_gather/
reduce_scatter, NCCL on GPUs) during pjit partitioning. FSDP-style param sharding covers
whisper-large-v3 fine-tunes (SURVEY §2.3).
"""

from .mesh import build_mesh, batch_sharding, param_sharding, replicated  # noqa: F401
from .multihost import initialize as initialize_multihost, is_primary  # noqa: F401
