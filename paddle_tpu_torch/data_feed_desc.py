"""fluid.data_feed_desc (counterpart of paddle_tpu/data_feed_desc.py; ref
python/paddle/fluid/data_feed_desc.py).

The reference wraps a protobuf-text config for the C++ MultiSlotDataFeed.
The port takes the same information as plain Python (Dataset API /
native data plane), so DataFeedDesc here is a light config holder with
the reference's setters, parsed from the same proto-text format (name/
type/is_dense/is_used fields of multi_slot_desc, batch_size) — enough
for scripts that build the desc then hand it to a Dataset.
"""
import re

__all__ = ["DataFeedDesc"]


class DataFeedDesc(object):
    def __init__(self, proto_file):
        with open(proto_file) as f:
            text = f.read()
        self._text = text
        self.batch_size = None
        m = re.search(r"batch_size\s*:\s*(\d+)", text)
        if m:
            self.batch_size = int(m.group(1))
        self._slots = []
        for blk in re.findall(r"slots\s*\{([^}]*)\}", text):
            slot = {}
            for key in ("name", "type"):
                m = re.search(r"%s\s*:\s*\"([^\"]+)\"" % key, blk)
                if m:
                    slot[key] = m.group(1)
            for key in ("is_dense", "is_used"):
                m = re.search(r"%s\s*:\s*(\w+)" % key, blk)
                slot[key] = (m.group(1).lower() == "true") if m else False
            self._slots.append(slot)
        self.__name_to_index = {s["name"]: i
                                for i, s in enumerate(self._slots)}

    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_dense_slots(self, dense_slots_name):
        for name in dense_slots_name:
            self._slots[self.__name_to_index[name]]["is_dense"] = True

    def set_use_slots(self, use_slots_name):
        for name in use_slots_name:
            self._slots[self.__name_to_index[name]]["is_used"] = True

    def slots(self):
        return [dict(s) for s in self._slots]

    def desc(self):
        """Re-serialize the (possibly mutated) config: the reference
        returns text_format.MessageToString of the LIVE proto, so
        setters must be visible to consumers of desc()."""
        text = self._text
        if self.batch_size is not None:
            text = re.sub(r"batch_size\s*:\s*\d+",
                          "batch_size: %d" % self.batch_size, text, count=1)

        slot_iter = iter(self._slots)

        def render(m):
            slot = next(slot_iter)
            blk = m.group(1)
            for key in ("is_dense", "is_used"):
                val = "true" if slot.get(key) else "false"
                blk, n = re.subn(r"%s\s*:\s*\w+" % key,
                                 "%s: %s" % (key, val), blk)
                if not n:
                    blk = blk.rstrip() + "\n        %s: %s\n    " \
                        % (key, val)
            return "slots {%s}" % blk

        return re.sub(r"slots\s*\{([^}]*)\}", render, text)
