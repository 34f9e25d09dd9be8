"""Command line of the port: `python -m face_recognition_models_tpu_torch.cli`."""
