"""Dataset-directory preprocessing helpers.

Counterpart of paddle_tpu/utils/preprocess_util.py. Reference parity:
python/paddle/utils/preprocess_util.py — walk a
class-per-subdirectory corpus, assign labels, split train/test, and
batch samples into pickled block files the readers can stream.
"""
import os
import pickle
import random

__all__ = ["save_file", "save_list", "exclude_pattern", "list_dirs",
           "list_images", "list_files", "get_label_set_from_dir",
           "Label", "Dataset", "DataBatcher", "DatasetCreater"]


def save_file(data, filename):
    """Pickle ``data`` to ``filename``."""
    with open(filename, "wb") as f:
        pickle.dump(data, f, protocol=4)


def save_list(l, outfile):
    """Write one item per line."""
    with open(outfile, "w") as f:
        for item in l:
            f.write("%s\n" % (item,))


def exclude_pattern(f):
    """True for hidden/system entries that should be skipped."""
    return f.startswith(".") or f.endswith("~")


def list_dirs(path):
    """Immediate subdirectories of ``path`` (hidden ones excluded)."""
    return sorted(
        d for d in os.listdir(path)
        if os.path.isdir(os.path.join(path, d)) and not exclude_pattern(d))


def list_images(path, exts=frozenset(("jpg", "png", "bmp", "jpeg"))):
    """Image files directly under ``path``."""
    return sorted(
        f for f in os.listdir(path)
        if os.path.isfile(os.path.join(path, f)) and not exclude_pattern(f)
        and f.rsplit(".", 1)[-1].lower() in exts)


def list_files(path):
    """All regular files directly under ``path``."""
    return sorted(
        f for f in os.listdir(path)
        if os.path.isfile(os.path.join(path, f))
        and not exclude_pattern(f))


def get_label_set_from_dir(path):
    """{class_subdirectory_name: integer_label} for a class-per-dir
    corpus."""
    return {name: i for i, name in enumerate(list_dirs(path))}


class Label(object):
    """A (label, name) pair with the reference's convert/dump surface."""

    def __init__(self, label, name):
        self.label = int(label)
        self.name = name

    def convert_to_paddle_format(self):
        return [self.label]

    def __hash__(self):
        return hash((self.label, self.name))

    def __eq__(self, other):
        return (isinstance(other, Label) and self.label == other.label
                and self.name == other.name)

    def __repr__(self):
        return "Label(%d, %r)" % (self.label, self.name)


class Dataset(object):
    """A list of samples, each ``(data_items..., label)``; knows how to
    shuffle and persist itself in block files."""

    def __init__(self, data, keys):
        self.data = list(data)
        self.keys = list(keys)

    def check_valid(self):
        for item in self.data:
            if len(item) != len(self.keys):
                raise ValueError(
                    "sample arity %d != key arity %d"
                    % (len(item), len(self.keys)))
        return True

    def permute(self, key_id=None, num_per_batch=None, seed=0):
        """Shuffle samples (the reference's class-balancing permute
        degenerates to a seeded shuffle for the dense pipeline)."""
        rng = random.Random(seed)
        rng.shuffle(self.data)
        return self

    def __len__(self):
        return len(self.data)


class DataBatcher(object):
    """Split a Dataset into fixed-size blocks and save each block with
    save_file — the reference's batch-file layout readers stream."""

    def __init__(self, train_data, test_data, label_set):
        self.train_data = train_data
        self.test_data = test_data
        self.label_set = label_set
        self.num_per_batch = 1024

    def create_batches_and_list(self, output_path, train_list_name,
                                test_list_name, label_set_name):
        train_files = self._save_blocks(self.train_data, output_path,
                                        "train")
        test_files = self._save_blocks(self.test_data, output_path, "test")
        save_list(train_files, os.path.join(output_path, train_list_name))
        save_list(test_files, os.path.join(output_path, test_list_name))
        save_file(self.label_set, os.path.join(output_path,
                                               label_set_name))
        return train_files, test_files

    def _save_blocks(self, dataset, output_path, prefix):
        names = []
        for i in range(0, len(dataset.data), self.num_per_batch):
            name = "%s_batch_%03d" % (prefix, i // self.num_per_batch)
            save_file({"keys": dataset.keys,
                       "data": dataset.data[i:i + self.num_per_batch]},
                      os.path.join(output_path, name))
            names.append(name)
        return names


class DatasetCreater(object):
    """Base corpus builder: subclasses implement create_dataset_from_dir
    (ref DatasetCreater.create_dataset_from_list/dir)."""

    def __init__(self, data_path):
        self.data_path = data_path
        self.train_dir_name = "train"
        self.test_dir_name = "test"
        self.batch_dir_name = "batches"
        self.train_list_name = "train.list"
        self.test_list_name = "test.list"
        self.label_set_name = "labels.pkl"
        self.num_per_batch = 1024
        self.overwrite = False

    def create_dataset_from_dir(self, path, label_set=None):
        """Build a Dataset from one split directory. ``label_set`` is
        the train-split {class: label} mapping — use it (when given) so
        every split numbers classes identically."""
        raise NotImplementedError(
            "subclass DatasetCreater and build a Dataset from %r" % path)

    def create_batches(self):
        train_path = os.path.join(self.data_path, self.train_dir_name)
        test_path = os.path.join(self.data_path, self.test_dir_name)
        out_path = os.path.join(self.data_path, self.batch_dir_name)
        if os.path.exists(out_path) and not self.overwrite:
            return out_path
        os.makedirs(out_path, exist_ok=True)
        label_set = get_label_set_from_dir(train_path)
        train = self.create_dataset_from_dir(train_path, label_set)
        test = self.create_dataset_from_dir(test_path, label_set)
        batcher = DataBatcher(train, test, label_set)
        batcher.num_per_batch = self.num_per_batch
        batcher.create_batches_and_list(out_path, self.train_list_name,
                                        self.test_list_name,
                                        self.label_set_name)
        return out_path
