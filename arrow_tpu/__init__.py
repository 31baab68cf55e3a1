"""arrow_tpu — a vectorized query-execution engine for accelerators.

Built from scratch in JAX/XLA with the compute-kernel capabilities of
the Apache Arrow Rust implementation (arrow-rs, see SURVEY.md): columnar
device-resident tables with validity-mask tensors, fused element-wise kernels,
selection (filter/take), order-preserving row-format sort, cast, aggregation,
hash group-by and hash join, scaled over multi-device meshes with
hash-partitioned shuffles.

Facade layout mirrors the reference's `arrow` umbrella crate
(arrow/src/lib.rs:385-411): `arrow_tpu.compute` re-exports all kernels;
the core array/table model lives at top level.
"""

from . import config  # noqa: F401  (must run first: enables x64)

from . import dtypes
from .dtypes import (  # noqa: F401
    DataType, Field, Schema, ExtensionType,
    null, bool_, int8, int16, int32, int64,
    uint8, uint16, uint32, uint64, float16, float32, float64,
    utf8, large_utf8, utf8_view, binary, large_binary, binary_view,
    fixed_size_binary, date32, date64,
    timestamp, time32, time64, duration, interval,
    decimal32, decimal64, decimal128, decimal256,
    dictionary, list_, large_list, struct, fixed_size_list, map_,
    union, run_end_encoded,
    uuid, json_, bool8, fixed_shape_tensor, opaque,
)
from .errors import (  # noqa: F401
    ArrowError, ArrowTypeError, ArrowInvalid, ArrowNotImplementedError,
    ArithmeticOverflow, DivideByZero, CastError, ParseError,
)
from .core.column import (  # noqa: F401
    Column, PrimitiveColumn, StringColumn, DictionaryColumn,
    ListColumn, StructColumn, NullColumn, column,
)
from .core.nested import (  # noqa: F401
    FixedSizeListColumn, FixedSizeBinaryColumn, MapColumn,
    UnionColumn, RunEndColumn, DecimalColumn, IntervalMDNColumn,
)
from .core.datum import Scalar, scalar  # noqa: F401
from .core.table import Table, RecordBatch  # noqa: F401
from .core.tensor import Tensor  # noqa: F401
from .fuse import fuse  # noqa: F401
from .core.pool import (  # noqa: F401
    MemoryPool, TrackingMemoryPool, MemoryReservation,
    column_memory_size, table_memory_size,
)
from .core import builders  # noqa: F401
from .utils.display import (  # noqa: F401
    FormatOptions, ArrayFormatter, pretty_format_table,
    pretty_format_columns,
)
from .utils.trace import op_timer, timings, OpTimings  # noqa: F401

from . import ops as compute  # noqa: F401

__version__ = "0.1.0"
