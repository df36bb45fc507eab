"""Data readers (counterpart of paddle_tpu/reader): the reader
decorators and DataLoader. ``sharded_feed`` (ShardedFeed) waits for the
multi-GPU slice; ROADMAP.md lists it."""
from .decorator import (batch, shuffle, buffered, chain,  # noqa: F401
                        compose, firstn, ComposeNotAligned, map_readers,
                        xmap_readers, cache, multiprocess_reader)
from .dataloader import DataLoader  # noqa: F401
