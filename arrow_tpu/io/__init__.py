"""I/O & interchange layer (SURVEY.md §2.3 L4/L5): pyarrow interop,
Arrow IPC file/stream, CSV, JSON, Parquet, Avro, Flight RPC."""

from . import ipc  # noqa: F401
from . import csv  # noqa: F401
from . import json_io  # noqa: F401
from . import parquet_io  # noqa: F401
from . import avro  # noqa: F401
from . import integration_json  # noqa: F401
from . import records  # noqa: F401

# the pyarrow bridge loads on first use: pyarrow is optional, and the
# native readers and writers above do not need it
_INTEROP = ("column_from_pyarrow", "column_to_pyarrow", "table_from_pyarrow",
            "table_to_pyarrow", "dtype_from_pyarrow", "dtype_to_pyarrow")


def __getattr__(name):
    if name in _INTEROP:
        from . import interop
        return getattr(interop, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
