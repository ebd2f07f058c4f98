"""The Python side of the C++ batch prefetcher (csrc/prefetch_loader.cpp).

Counterpart of contouring_uncertainty_tpu/data/native_loader.py with the
same ctypes surface: a worker thread of the library gathers shuffled
batches (std::mt19937_64(seed + epoch), std::shuffle, drop_last) into a ring
of slots, and `epoch()` copies each filled slot out as numpy arrays: the
images in their own dtype (float32, or uint8 for `feed_uint8`), `gt` as
uint8, `contour` as float32. Built by build.py with g++ at first use; where
it cannot be built, `NativePrefetcher` raises RuntimeError and the trainer
batches with numpy (`trainer._iterate`), as the JAX trainer does.

`batches_served` counts the batches copied out of the ring since the last
reset, and `library_file` is the library they came from.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from contouring_uncertainty_torch.data.config import Tags

_LIB = None
_TRIED = False
library_file: Optional[Path] = None
batches_served = 0


def _library():
    global _LIB, _TRIED, library_file
    if not _TRIED:
        _TRIED = True
        from contouring_uncertainty_torch.build import build_host_library

        path = build_host_library("prefetch_loader")
        lib = None
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                lib = None
        if lib is not None:
            lib.pf_create.restype = ctypes.c_void_p
            lib.pf_create.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_uint64, ctypes.c_int,
            ]
            lib.pf_next.restype = ctypes.c_int
            lib.pf_next.argtypes = [ctypes.c_void_p]
            lib.pf_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.pf_buffers.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ]
            lib.pf_destroy.argtypes = [ctypes.c_void_p]
            library_file = path
        _LIB = lib
    return _LIB


class NativePrefetcher:
    """Shuffled batches assembled by the library's worker thread.

    Holds the source arrays (contiguous copies where needed; they stay
    alive with the prefetcher) and yields dicts of numpy arrays copied out
    of the ring slots. Raises ValueError for fewer frames than
    `batch_size` (no whole batch) and RuntimeError where the library is
    unavailable."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0, n_slots: int = 4):
        n = len(arrays[Tags.img])
        if n < batch_size:
            raise ValueError(f"{n} training frames cannot fill one batch of {batch_size}: "
                             f"lower trainer.batch_size to at most {n}")
        lib = _library()
        if lib is None:
            raise RuntimeError("native prefetch library unavailable")
        self._lib = lib
        self.batch_size = batch_size
        img_src = arrays[Tags.img]
        img_dtype = np.uint8 if img_src.dtype == np.uint8 else np.float32
        self.imgs = np.ascontiguousarray(img_src, img_dtype)
        self.gts = (np.ascontiguousarray(arrays[Tags.gt], np.uint8)
                    if Tags.gt in arrays else None)
        self.contours = (np.ascontiguousarray(arrays[Tags.contour], np.float32)
                         if Tags.contour in arrays else None)
        self.n_batches = n // batch_size
        self._img_shape = (batch_size,) + self.imgs.shape[1:]
        self._gt_shape = (batch_size,) + (self.gts.shape[1:] if self.gts is not None else ())
        self._cont_shape = (batch_size,) + (self.contours.shape[1:]
                                            if self.contours is not None else ())
        self._handle = lib.pf_create(
            self.imgs.ctypes.data_as(ctypes.c_void_p),
            self.gts.ctypes.data_as(ctypes.c_void_p) if self.gts is not None else None,
            self.contours.ctypes.data_as(ctypes.c_void_p) if self.contours is not None else None,
            n,
            int(np.prod(self.imgs.shape[1:])) * self.imgs.dtype.itemsize,
            int(np.prod(self.gts.shape[1:])) if self.gts is not None else 0,
            int(np.prod(self.contours.shape[1:])) if self.contours is not None else 0,
            batch_size, seed, n_slots,
        )

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        """The next epoch's `n_batches` batches, in the library's order."""
        global batches_served
        lib = self._lib
        n_img_bytes = int(np.prod(self._img_shape)) * self.imgs.dtype.itemsize
        for _ in range(self.n_batches):
            slot = lib.pf_next(self._handle)
            if slot < 0:
                return
            img_p = ctypes.POINTER(ctypes.c_uint8)()
            gt_p = ctypes.POINTER(ctypes.c_uint8)()
            cont_p = ctypes.POINTER(ctypes.c_float)()
            lib.pf_buffers(self._handle, slot, ctypes.byref(img_p),
                           ctypes.byref(gt_p), ctypes.byref(cont_p))
            img_flat = np.ctypeslib.as_array(img_p, (n_img_bytes,))
            batch = {Tags.img: img_flat.view(self.imgs.dtype).reshape(self._img_shape).copy()}
            if self.gts is not None:
                batch[Tags.gt] = np.ctypeslib.as_array(gt_p, self._gt_shape).copy()
            if self.contours is not None:
                batch[Tags.contour] = np.ctypeslib.as_array(cont_p, self._cont_shape).copy()
            lib.pf_release(self._handle, slot)
            batches_served += 1
            yield batch

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.pf_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
