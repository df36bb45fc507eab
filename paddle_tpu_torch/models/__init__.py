"""Model zoo of the port (counterpart of paddle_tpu/models/): BERT, GPT,
ResNet, DeepFM, the Transformer, BiGRU-CRF sequence labeling and
CRNN-CTC text recognition so far."""
from . import bert, deepfm, gpt, ocr, resnet, sequence_labeling  # noqa: F401
