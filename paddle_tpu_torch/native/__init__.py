"""The C++ data plane (counterpart of paddle_tpu/native): record files
read by threads into a ring buffer with a shuffle pool, and the MultiSlot
text parser; built with g++ at first use (``build.py``)."""
from .build import (DataPlaneBuildError, load_dataplane,  # noqa: F401
                    native_available)
from .recordio import (RecordWriter, RecordReader,  # noqa: F401
                       write_records, NativeDataLoader)
from .multislot import MultiSlotTextReader  # noqa: F401
