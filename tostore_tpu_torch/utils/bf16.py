"""bfloat16 host arrays without a bfloat16 numpy dtype.

numpy has no bfloat16. The JAX package carries bf16 rows on the host as
`ml_dtypes` arrays and the codec gives them the frozen wire tag 8
(utils/codec.py). The port does not depend on `ml_dtypes`: it carries the
same 16 bits per value in a `uint16` array inside `BF16Array`, whose
`dtype.name` reads `"bfloat16"` like the `ml_dtypes` type's. The codec
writes and reads tag 8 through it, so a bf16 corpus stays 2 bytes a value
on disk and the byte stream equals the JAX package's for the same values.

Both kinds of array answer `.dtype.name == "bfloat16"` and
`.view(np.int16)`, which is all that the loaders (convert.py) ask of them.
"""

from __future__ import annotations

import numpy as np


class _BF16Dtype:
    """Stands where a numpy dtype would: a name, an item size, equality."""

    name = "bfloat16"
    itemsize = 2

    def __eq__(self, other):
        return getattr(other, "name", other) == "bfloat16"

    def __hash__(self):
        return hash("bfloat16")

    def __repr__(self):
        return "bfloat16"


BFLOAT16 = _BF16Dtype()


def is_bf16(a) -> bool:
    """True for a `BF16Array` and for an `ml_dtypes` bfloat16 ndarray."""
    return getattr(getattr(a, "dtype", None), "name", None) == "bfloat16"


class BF16Array:
    """An n-d array of bfloat16 values held as their bits (`uint16`)."""

    __slots__ = ("bits",)
    dtype = BFLOAT16

    def __init__(self, bits: np.ndarray):
        if bits.dtype.itemsize != 2 or bits.dtype.kind not in "iu":
            raise TypeError(f"BF16Array wants 16-bit integer bits, got {bits.dtype}")
        self.bits = bits.view(np.uint16)

    shape = property(lambda self: self.bits.shape)
    ndim = property(lambda self: self.bits.ndim)
    nbytes = property(lambda self: self.bits.nbytes)

    def __len__(self):
        return len(self.bits)

    def __getitem__(self, key):
        out = self.bits[key]
        if isinstance(out, np.ndarray):
            return BF16Array(out)
        return self._widen(np.asarray(out))[()]

    def view(self, dtype):
        """The bits as a 16-bit integer array (shares memory)."""
        return self.bits.view(dtype)

    @staticmethod
    def _widen(bits: np.ndarray) -> np.ndarray:
        return (bits.astype(np.uint32) << 16).view(np.float32)

    def __array__(self, dtype=None, copy=None):
        # widening bf16 to float32 is exact
        f = self._widen(self.bits)
        return f if dtype is None else f.astype(dtype, copy=False)

    def __repr__(self):
        return f"BF16Array(shape={self.shape})"
