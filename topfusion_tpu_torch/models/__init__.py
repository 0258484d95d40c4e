from .block_pipeline import BlockPipeline, BlockState

__all__ = ["BlockPipeline", "BlockState"]
