"""Applications of the PyTorch/CUDA port (``python -m topfusion_tpu_torch.apps.run_fusion``)."""
