"""The paper's workload: a Wan2.1-style image-to-video diffusion pipeline
decomposed into the four OnePiece stages (§2.4):

    T5&CLIP text conditioning -> VAE encode -> DiT diffusion -> VAE decode

Each stage is a self-contained PyTorch model so the cluster layer can place
them on separate workflow instances and move tensors between them as
WorkflowMessages over the RDMA fabric.
"""
from repro_torch.models.aigc.pipeline import (
    DAG_DEPS,
    WanI2VPipeline,
    build_dag_stage_fns,
    build_stage_fns,
)

__all__ = ["DAG_DEPS", "WanI2VPipeline", "build_dag_stage_fns",
           "build_stage_fns"]
