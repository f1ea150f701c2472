"""Data iterators: the composable chain of ``cxxnet_tpu/io/__init__.py``
(reference: src/io/data.h:19-188), the part of it the AlexNet training
slice runs.

The reference iterator protocol (set_param/init/before_first/next/value)
is kept because configs name iterators and their params. Base iterators
produce whole ``DataBatch``es of host (numpy) arrays; ``threadbuffer``
adds host-side prefetch on a background thread. ``synth`` draws exactly
what the JAX package's draws (the same ``np.random.RandomState`` calls
in the same order), so one config gives the same batches in both
packages. ``imgbin``/``img``/``imgbinx``, ``mnist``, ``membuffer`` and
``attachtxt`` come with a later slice and raise naming it.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

ConfigEntry = Tuple[str, str]

_LATER = {
    "mnist": "the CNN zoo and data slice",
    "membuffer": "the CNN zoo and data slice",
    "attachtxt": "the CNN zoo and data slice",
    "imgbin": "the CNN zoo and data slice (io/image.py)",
    "imgbinx": "the CNN zoo and data slice (io/image.py)",
    "img": "the CNN zoo and data slice (io/image.py)",
}


@dataclass
class DataBatch:
    """One dense batch (reference: src/io/data.h:79-150).

    data: (batch, channel, height, width) float32
    label: (batch, label_width) float32
    num_batch_padd: trailing instances that are padding
    """
    data: np.ndarray
    label: np.ndarray
    num_batch_padd: int = 0
    extra_data: List[np.ndarray] = field(default_factory=list)
    inst_index: Optional[np.ndarray] = None

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]


class DataIterator:
    """Iterator protocol (reference: src/io/data.h:19-38)."""

    def set_param(self, name: str, val: str) -> None:
        pass

    def init(self) -> None:
        pass

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self) -> bool:
        raise NotImplementedError

    @property
    def value(self) -> DataBatch:
        raise NotImplementedError

    def __iter__(self):
        self.before_first()
        while self.next():
            yield self.value


class ArrayIterator(DataIterator):
    """Serve an in-memory (n, c, h, w) array + labels as DataBatches with
    the reference's tail semantics (iter_mnist-inl.hpp:14-158): with
    round_batch the tail wraps to the head and reports num_batch_padd;
    otherwise the tail partial batch is dropped."""

    def __init__(self, data: np.ndarray, label: np.ndarray,
                 batch_size: int, shuffle: bool = False,
                 round_batch: bool = True, seed: int = 0) -> None:
        self.data = data
        self.label = label if label.ndim == 2 else label[:, None]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.round_batch = round_batch
        self.rng = np.random.RandomState(seed)
        self.order = np.arange(data.shape[0])
        self._pos = 0
        self._batch: Optional[DataBatch] = None

    def before_first(self) -> None:
        self._pos = 0
        if self.shuffle:
            self.rng.shuffle(self.order)

    def next(self) -> bool:
        n = self.data.shape[0]
        bs = self.batch_size
        if self._pos + bs <= n:
            idx = self.order[self._pos:self._pos + bs]
            self._batch = DataBatch(self.data[idx], self.label[idx],
                                    num_batch_padd=0, inst_index=idx)
            self._pos += bs
            return True
        remain = n - self._pos
        if remain > 0 and self.round_batch:
            # wrap around to the head (cycling if batch > dataset)
            reps = -(-(bs - remain) // n)
            head = np.tile(self.order, reps)[: bs - remain]
            idx = np.concatenate([self.order[self._pos:], head])
            self._batch = DataBatch(self.data[idx], self.label[idx],
                                    num_batch_padd=bs - remain,
                                    inst_index=idx)
            self._pos = n
            return True
        return False

    @property
    def value(self) -> DataBatch:
        return self._batch


class SyntheticIterator(ArrayIterator):
    """Deterministic synthetic classification data (no reference analogue):
    gaussian inputs labelled by the argmax of a fixed random projection,
    so small nets can learn them. The draws are the JAX package's
    (io/__init__.py:125-218), call for call."""

    def __init__(self) -> None:
        self.shape = (1, 1, 16)
        self.nclass = 4
        self.ninst = 512
        self.batch_size_cfg = 64
        self.shuffle_cfg = False
        self.seed = 0
        self.round_batch_cfg = True
        self.label_width = 1
        self.token_vocab = 0
        self.lm_labels = 0

    def set_param(self, name: str, val: str) -> None:
        if name in ("shape", "input_shape"):
            self.shape = tuple(int(x) for x in val.split(","))
        elif name == "nclass":
            self.nclass = int(val)
        elif name == "ninst":
            self.ninst = int(val)
        elif name == "batch_size":
            self.batch_size_cfg = int(val)
        elif name == "shuffle":
            self.shuffle_cfg = bool(int(val))
        elif name == "seed":
            self.seed = int(val)
        elif name == "round_batch":
            self.round_batch_cfg = bool(int(val))
        elif name == "label_width":
            self.label_width = int(val)
        elif name == "token_vocab":
            self.token_vocab = int(val)
        elif name == "lm_labels":
            self.lm_labels = int(val)

    def init(self) -> None:
        if self.token_vocab > 0:
            raise NotImplementedError(
                "synth token_vocab (token sequences) comes with the "
                "transformer slice (ROADMAP.md)")
        rng = np.random.RandomState(self.seed + 42)
        c, h, w = self.shape
        # the labelling rule is drawn FIRST so train/eval iterators with
        # different ninst share the same ground-truth function
        proj = rng.randn(c * h * w, self.nclass).astype(np.float32)
        x = rng.randn(self.ninst, c, h, w).astype(np.float32)
        logits = x.reshape(self.ninst, -1) @ proj
        y = logits.argmax(axis=1).astype(np.float32)
        label = np.tile(y[:, None], (1, self.label_width))
        super().__init__(x, label, self.batch_size_cfg,
                         shuffle=self.shuffle_cfg,
                         round_batch=self.round_batch_cfg, seed=self.seed)


class ProducerFailure:
    """Sentinel a producer thread enqueues in place of an item when it
    dies: carries the exception so the consumer re-raises it from
    ``next()`` instead of hanging on a queue that will never fill."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc

    def reraise(self) -> None:
        raise RuntimeError(
            "feed producer thread failed: %s" % self.exc) from self.exc


class ThreadBufferIterator(DataIterator):
    """Background-thread batch prefetch (reference:
    src/io/iter_batch_proc-inl.hpp:136-226, utils/thread_buffer.h:22): a
    bounded queue keeps ``buffer_size`` batches ready ahead of the
    consumer. A producer-side error is forwarded through the queue and
    re-raised by ``next()``."""

    def __init__(self, base: DataIterator, buffer_size: int = 2) -> None:
        self.base = base
        self.buffer_size = buffer_size
        self._queue = None
        self._thread = None
        self._batch: Optional[DataBatch] = None

    def set_param(self, name: str, val: str) -> None:
        if name == "buffer_size":
            self.buffer_size = int(val)
            if self.buffer_size < 1:
                raise ValueError("threadbuffer: buffer_size must be >= 1")
        else:
            self.base.set_param(name, val)

    def init(self) -> None:
        self.base.init()

    def _producer(self, q) -> None:
        try:
            self.base.before_first()
            while self.base.next():
                q.put(self.base.value)
        except BaseException as e:
            q.put(ProducerFailure(e))
            return
        q.put(None)

    def _drain(self) -> None:
        """Pull the running producer's queue to its end (or failure)
        sentinel so it can exit, then join it."""
        while not isinstance(self._queue.get(), (type(None),
                                                 ProducerFailure)):
            pass
        self._thread.join()

    def before_first(self) -> None:
        if self._thread is not None:
            self._drain()
        self._queue = queue_mod.Queue(maxsize=self.buffer_size)
        self._thread = threading.Thread(
            target=self._producer, args=(self._queue,), daemon=True)
        self._thread.start()

    def next(self) -> bool:
        if self._queue is None:
            self.before_first()
        item = self._queue.get()
        if item is None or isinstance(item, ProducerFailure):
            self._thread.join()
            self._thread = None
            self._queue = None
            if item is not None:
                item.reraise()
            return False
        self._batch = item
        return True

    @property
    def value(self) -> DataBatch:
        return self._batch


def create_iterator(cfg: Sequence[ConfigEntry],
                    defaults: Sequence[ConfigEntry] = ()) -> DataIterator:
    """Factory chaining iterators in config order
    (reference: src/io/data.cpp:24-75; io/__init__.py:502-558 of the JAX
    package). ``defaults`` are the global config keys, applied to the
    finished chain after the section keys and before init — how a global
    ``batch_size`` / ``input_shape`` reaches every iterator."""
    base: Optional[DataIterator] = None
    pre_params: List[ConfigEntry] = []
    for name, val in cfg:
        if name == "iter":
            if val == "synth":
                base = SyntheticIterator()
            elif val == "threadbuffer":
                if base is None:
                    raise ValueError("threadbuffer needs a base iterator")
                base = ThreadBufferIterator(base)
            elif val == "end":
                continue
            elif val in _LATER:
                raise NotImplementedError(
                    "iter = %s is not ported yet: it comes with %s "
                    "(ROADMAP.md); use iter = synth" % (val, _LATER[val]))
            else:
                raise ValueError("unknown iterator type %s" % val)
            for k, v in pre_params:
                base.set_param(k, v)
            pre_params = []
        elif base is None:
            pre_params.append((name, val))
        else:
            base.set_param(name, val)
    if base is None:
        raise ValueError("config does not declare an iterator")
    for k, v in defaults:
        base.set_param(k, v)
    base.init()
    return base
