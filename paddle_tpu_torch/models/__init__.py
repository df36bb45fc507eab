"""Model zoo of the port (counterpart of paddle_tpu/models/): BERT, GPT,
ResNet and DeepFM so far."""
from . import bert, deepfm, gpt, resnet  # noqa: F401
