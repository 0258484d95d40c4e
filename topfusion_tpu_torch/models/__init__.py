from .block_pipeline import BlockPipeline, BlockState
from .pipeline import DensePipeline, DenseState

__all__ = ["DensePipeline", "DenseState", "BlockPipeline", "BlockState"]
