"""Operations and bytes of the program's kernels, frozen as the benchmark
was defined, one file a kernel, and the card's published peaks
(``peaks.json``). Each file gives ``KERNEL``, a pattern for the kernel's
names in a device trace, and ``work(...) -> (operations, bytes)``."""

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "peaks.json")) as _f:
    PEAKS = json.load(_f)


def least_seconds(flops: float, nbytes: float, elem_bytes: int):
    """(seconds, "operations" or "bytes"): the least time the card could
    take, the larger of the operations over its rate for the values' type
    and the bytes over its memory rate, and which of the two bounds it."""
    by = {"operations": flops / PEAKS["flops"][str(elem_bytes)],
          "bytes": nbytes / PEAKS["bytes_per_s"]}
    which = max(by, key=by.get)
    return by[which], which
