"""Command-line entry points of the port: ``python -m
attwarp_tpu_torch.cli.serve``. (``process_dataset`` holds only the backend
spec grammar so far.)"""
