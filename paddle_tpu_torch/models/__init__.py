"""Model zoo of the port (counterpart of paddle_tpu/models/): BERT and GPT
so far."""
from . import bert, gpt  # noqa: F401
