"""User-defined data generators for Dataset pipelines (counterpart of
paddle_tpu/incubate/data_generator; ref python/paddle/fluid/incubate/
data_generator/__init__.py).

Subclass DataGenerator / MultiSlotDataGenerator, implement
``generate_sample(line)``, and the generator renders slot-formatted
text lines that the Dataset API reads through the C++ MultiSlot parser
(paddle_tpu_torch/dataset/dataset_api.py). The slot text format is the
reference's: ``<slot_len> v0 v1 ...`` per slot, space-joined.
"""
import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator(object):
    """Base class (ref :21): drive lines through generate_sample /
    generate_batch and emit slot text to stdout (the Dataset feeds the
    emitted stream to its readers)."""

    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32

    def _set_line_limit(self, line_limit):
        if not isinstance(line_limit, int):
            raise ValueError("line_limit%s must be in int type" %
                             type(line_limit))
        if line_limit < 1:
            raise ValueError("line_limit can not less than 1")
        self._line_limit = line_limit

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def _emit(self, sample, write):
        write(self._gen_str(sample))

    def run_from_memory(self, write=None):
        """Generate from memory (ref :66); ``write`` defaults to
        sys.stdout.write — pass a collector for in-process use."""
        write = write or sys.stdout.write
        batch_samples = []
        line_iter = self.generate_sample(None)
        for parsed in line_iter():
            if parsed is None:
                continue
            batch_samples.append(parsed)
            if len(batch_samples) == self.batch_size_:
                for sample in self.generate_batch(batch_samples)():
                    self._emit(sample, write)
                batch_samples = []
        if batch_samples:
            for sample in self.generate_batch(batch_samples)():
                self._emit(sample, write)

    def run_from_stdin(self, read=None, write=None):
        """Parse lines from stdin and emit slot text (ref :100)."""
        read = read or sys.stdin
        write = write or sys.stdout.write
        batch_samples = []
        for line in read:
            line_iter = self.generate_sample(line)
            for parsed in line_iter():
                if parsed is None:
                    continue
                batch_samples.append(parsed)
                if len(batch_samples) == self.batch_size_:
                    for sample in self.generate_batch(batch_samples)():
                        self._emit(sample, write)
                    batch_samples = []
        if batch_samples:
            for sample in self.generate_batch(batch_samples)():
                self._emit(sample, write)

    def _gen_str(self, line):
        raise NotImplementedError(
            "Please inherit MultiSlotDataGenerator or "
            "MultiSlotStringDataGenerator to implement _gen_str")

    def generate_sample(self, line):
        raise NotImplementedError(
            "Please rewrite this function to return a list or tuple: " +
            "[(name, [feasign, ...]), ...] or ((name, [feasign, ...]), ...)")

    def generate_batch(self, samples):
        def local_iter():
            for sample in samples:
                yield sample

        return local_iter


def _check_slots(line):
    if not isinstance(line, (list, tuple)):
        raise ValueError(
            "the output of process() must be in list or tuple type")
    for item in line:
        if not isinstance(item, (list, tuple)) or len(item) != 2:
            raise ValueError("each slot must be a (name, values) pair")
        name, elements = item
        if not isinstance(name, str):
            raise ValueError("the slot name %r is not a string" % (name,))
        if not isinstance(elements, (list, tuple)) or not elements:
            raise ValueError("slot %s must carry a non-empty value list" %
                             name)


class MultiSlotStringDataGenerator(DataGenerator):
    """Slots of raw strings (ref :241): text line =
    "len v0 v1 ... len v0 ..." per slot, space-joined."""

    def _gen_str(self, line):
        _check_slots(line)
        output = ""
        for item in line:
            name, elements = item
            if output:
                output += " "
            out_str = [str(len(elements))]
            out_str.extend(str(e) for e in elements)
            output += " ".join(out_str)
        return output + "\n"


class MultiSlotDataGenerator(DataGenerator):
    """Slots of ints/floats (ref :282), with per-slot type checking —
    a slot must stay int or float across all emitted samples."""

    def _gen_str(self, line):
        _check_slots(line)
        if self._proto_info is None:
            self._proto_info = []
            for name, elements in line:
                slot_type = "uint64"
                for e in elements:
                    if isinstance(e, float):
                        slot_type = "float"
                    elif not isinstance(e, int):
                        raise ValueError(
                            "the value of slot %s must be int or float" %
                            name)
                self._proto_info.append((name, slot_type))
        else:
            if len(line) != len(self._proto_info):
                raise ValueError(
                    "the complete field set of two given line are "
                    "inconsistent.")
            for i, (name, elements) in enumerate(line):
                if name != self._proto_info[i][0]:
                    raise ValueError(
                        "the complete field set of two given line are not "
                        "exactly the same.")
                if self._proto_info[i][1] != "float":
                    for e in elements:
                        if isinstance(e, float):
                            self._proto_info[i] = (name, "float")
                        elif not isinstance(e, int):
                            raise ValueError(
                                "the value of slot %s must be int or "
                                "float" % name)
        output = ""
        for name, elements in line:
            if output:
                output += " "
            out_str = [str(len(elements))]
            out_str.extend(str(e) for e in elements)
            output += " ".join(out_str)
        return output + "\n"
