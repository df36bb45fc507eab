"""Command-line tools of the port: ``progcheck`` (the Program verifier
over a saved model or a program dump) and ``serving_probe`` (a serving
artifact's readiness probe). Run each as ``python -m
paddle_tpu_torch.tools.<name>``."""
