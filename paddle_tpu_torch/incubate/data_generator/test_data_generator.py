"""Demo generators (counterpart of paddle_tpu/incubate/data_generator/
test_data_generator.py; ref incubate/data_generator/
test_data_generator.py):
the reference ships a tiny runnable example of both generator flavors;
kept for parity and as living documentation of the slot text format."""
from . import MultiSlotDataGenerator, MultiSlotStringDataGenerator

__all__ = ["SyntheticData", "SyntheticStringData"]


class SyntheticData(MultiSlotDataGenerator):
    def generate_sample(self, line):
        def data_iter():
            for i in range(10000):
                yield [("words", [1, 2, 3, 4]), ("label", [0])]

        return data_iter


class SyntheticStringData(MultiSlotStringDataGenerator):
    def generate_sample(self, line):
        def data_iter():
            for i in range(10000):
                yield [("words", ["1", "2", "3", "4"]),
                       ("label", ["0"])]

        return data_iter


if __name__ == "__main__":  # pragma: no cover - manual demo
    sd = SyntheticData()
    sd._set_line_limit(5)
    sd.run_from_memory()
