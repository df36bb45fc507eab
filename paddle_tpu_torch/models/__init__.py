"""Model zoo of the port (counterpart of paddle_tpu/models/): BERT so far."""
from . import bert  # noqa: F401
