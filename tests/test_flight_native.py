"""Own Flight gRPC layer interop vs pyarrow.flight peers
(arrow-flight/src/arrow.flight.protocol.rs:861, encode.rs:269,
decode.rs:83 parity — transport is ours, pyarrow is the peer oracle)."""

import numpy as np
import pyarrow as pa
import pyarrow.flight as fl
import pytest

import arrow_tpu as at
from arrow_tpu.io.flight import (FlightDescriptor, FlightServer,
                                 FlightTableClient)
from arrow_tpu.io.interop import table_from_pyarrow, table_to_pyarrow


@pytest.fixture()
def table():
    rng = np.random.default_rng(0)
    return at.Table.from_pydict({
        "a": rng.integers(-1000, 1000, 500),
        "b": rng.standard_normal(500),
        "s": [f"w{i % 7}" for i in range(500)],
    })


def test_our_client_vs_our_server(table):
    srv = FlightServer()
    try:
        srv.register("t", table)
        cli = FlightTableClient(srv.uri)
        got = cli.do_get("t")
        assert got.to_pydict() == table.to_pydict()
        assert cli.list_flights() == ["t"]
        # put + exchange + handshake + flight info
        cli.do_put("t2", table)
        assert srv.get_table("t2").num_rows == 500
        outs = cli.do_exchange("x", table)
        assert outs[0].to_pydict() == table.to_pydict()
        assert cli.handshake(b"hello") == b"hello"
        info = cli.get_flight_info(FlightDescriptor.for_path("t"))
        assert info.total_records == 500
        cli.close()
    finally:
        srv.shutdown()


def test_pyarrow_client_reads_our_server(table):
    srv = FlightServer()
    try:
        srv.register("t", table)
        c = fl.connect(srv.uri.replace("grpc://", "grpc://"))
        reader = c.do_get(fl.Ticket(b"t"))
        got = reader.read_all().combine_chunks()
        assert got.to_pydict() == table_to_pyarrow(table).to_pydict()
        # flight info via pyarrow
        info = c.get_flight_info(fl.FlightDescriptor.for_path(b"t"))
        assert info.total_records == 500
        assert [f.name for f in info.schema] == ["a", "b", "s"]
        # pyarrow writes to our server
        batch = table_to_pyarrow(table)
        writer, _ = c.do_put(fl.FlightDescriptor.for_path(b"up"),
                             batch.schema)
        writer.write_batch(batch)
        writer.close()
        import time
        time.sleep(0.2)
        assert srv.get_table("up").num_rows == 500
        c.close()
    finally:
        srv.shutdown()


def test_our_client_reads_pyarrow_server(table):
    batch = table_to_pyarrow(table)

    class PaServer(fl.FlightServerBase):
        def do_get(self, context, ticket):
            return fl.RecordBatchStream(pa.Table.from_batches([batch]))

        def do_put(self, context, descriptor, reader, writer):
            self.received = reader.read_all().combine_chunks()

        def list_flights(self, context, criteria):
            desc = fl.FlightDescriptor.for_path(b"t")
            yield fl.FlightInfo(batch.schema, desc,
                                [fl.FlightEndpoint(b"t", [])], 500, -1)

    srv = PaServer("grpc://localhost:0")
    try:
        cli = FlightTableClient(f"grpc://localhost:{srv.port}")
        got = cli.do_get("t")
        assert got.to_pydict() == table.to_pydict()
        assert cli.list_flights() == ["t"]
        cli.do_put("up", table)
        assert srv.received.to_pydict() == batch.to_pydict()
        cli.close()
    finally:
        srv.shutdown()


def test_dictionary_over_flight(table):
    from arrow_tpu.ops.strings import dictionary_encode
    d = dictionary_encode(table.column("s"))
    t2 = table.set_column(2, at.dtypes.Field("s", d.dtype), d)
    srv = FlightServer()
    try:
        srv.register("d", t2)
        # pyarrow reads our dictionary stream
        c = fl.connect(srv.uri)
        got = c.do_get(fl.Ticket(b"d")).read_all()
        assert got.column("s").to_pylist() == table.column("s").to_pylist()
        c.close()
        # our client round-trips it too
        cli = FlightTableClient(srv.uri)
        ours = cli.do_get("d")
        assert ours.column("s").to_pylist() == \
            table.column("s").to_pylist()
        cli.close()
    finally:
        srv.shutdown()


def test_large_stream_splits(table):
    # >2MB payload must arrive as multiple FlightData messages
    big = at.Table.from_pydict({
        "x": np.arange(1_000_000, dtype=np.int64),
        "y": np.arange(1_000_000, dtype=np.float64),
    })
    srv = FlightServer()
    try:
        srv.register("big", big)
        cli = FlightTableClient(srv.uri)
        parts = cli.do_get_stream("big")
        assert len(parts) > 1
        total = sum(p.num_rows for p in parts)
        assert total == 1_000_000
        cli.close()
    finally:
        srv.shutdown()


def test_no_pyarrow_imports_in_wire_modules():
    # the native wire paths must not import pyarrow (it remains the
    # test oracle only)
    import arrow_tpu.io.flight as flight_mod
    import arrow_tpu.io.ipc as ipc_mod
    import arrow_tpu.io.ipc_format as fmt_mod
    import arrow_tpu.io.parquet_native as pq_mod
    import arrow_tpu.io.parquet_writer as pw_mod
    import arrow_tpu.io.csv as csv_mod
    import arrow_tpu.io.json_io as json_mod
    import arrow_tpu.io.avro as avro_mod
    import arrow_tpu.io.thrift as thrift_mod
    import arrow_tpu.io.fb as fb_mod
    import arrow_tpu.io.pb as pb_mod
    import re
    for mod in (flight_mod, ipc_mod, fmt_mod, pq_mod, pw_mod, csv_mod,
                json_mod, avro_mod, thrift_mod, fb_mod, pb_mod):
        src = open(mod.__file__).read()
        assert not re.search(r"^\s*(import pyarrow|from pyarrow)", src,
                             re.M), mod.__name__


def test_flightinfo_zero_counts_roundtrip():
    """proto3 omits zero varints: known-empty (0) must decode as 0, and
    the explicit -1 'unknown' convention still round-trips."""
    from arrow_tpu.io.flight import FlightDescriptor, FlightInfo
    z = FlightInfo.decode(FlightInfo(
        b"s", FlightDescriptor.for_path("p"), [], 0, 0).encode())
    assert z.total_records == 0 and z.total_bytes == 0
    u = FlightInfo.decode(FlightInfo(
        b"s", FlightDescriptor.for_path("p"), [], -1, -1).encode())
    assert u.total_records == -1 and u.total_bytes == -1


def test_producer_schema_and_empty_stream():
    """register_producer(schema=...): get_flight_info advertises the
    real schema and an EMPTY producer stream still decodes (the stream
    opens with a schema message)."""
    srv = FlightServer()
    try:
        schema = at.Schema((at.Field("x", at.int64),))
        srv.register_producer("empty", lambda: iter(()), schema=schema)
        cli = FlightTableClient(srv.uri)
        info = cli.get_flight_info(FlightDescriptor.for_path("empty"))
        from arrow_tpu.io import ipc_format as fmt
        raw = info.schema_bytes
        if raw[:4] == b"\xff\xff\xff\xff":
            raw = raw[8:]
        got_schema, _ = fmt.read_schema(raw)
        assert [f.name for f in got_schema.fields] == ["x"]
        tables = cli.do_get_stream("empty")
        assert tables == [] or sum(t.num_rows for t in tables) == 0
        cli.close()
    finally:
        srv.shutdown()


def test_truncated_protobuf_raises():
    from arrow_tpu.io import pb
    from arrow_tpu.errors import ArrowInvalid
    msg = pb.field(1, b"hello")
    with pytest.raises(ArrowInvalid):
        pb.parse_fields(msg[:-3])


# ---------------------------------------------------------------------------
# round 3: auth handshake, middleware, error trailers
# (client.rs:139 handshake contract; integration middleware scenario)
# ---------------------------------------------------------------------------

def test_flight_basic_auth_roundtrip_and_rejection():
    import grpc
    import numpy as np
    import pytest
    import arrow_tpu as at
    from arrow_tpu.io.flight import (FlightServer, FlightTableClient,
                                     BasicAuthHandler, FlightError)
    auth = BasicAuthHandler({"alice": "secret"})
    srv = FlightServer("grpc://127.0.0.1:0", auth_handler=auth)
    srv.register("t", at.Table.from_pydict({"x": np.arange(4)}))
    try:
        # no token: every non-handshake RPC is rejected w/ trailers
        anon = FlightTableClient(srv.uri)
        with pytest.raises(FlightError) as ei:
            anon.do_get("t")
        assert ei.value.code == grpc.StatusCode.UNAUTHENTICATED
        assert ei.value.trailers.get("x-arrow-error-class") == \
            "FlightUnauthenticated"
        anon.close()
        # wrong password: handshake itself fails
        bad = FlightTableClient(srv.uri)
        with pytest.raises(FlightError) as ei:
            bad.authenticate_basic_token("alice", "wrong")
        assert ei.value.code == grpc.StatusCode.UNAUTHENTICATED
        bad.close()
        # valid: token issued, bearer header unlocks calls
        cli = FlightTableClient(srv.uri)
        token = cli.authenticate_basic_token("alice", "secret")
        assert token and auth.peer_identity(token.decode()) == "alice"
        out = cli.do_get("t")
        assert out.num_rows == 4
        cli.close()
    finally:
        srv.shutdown()


def test_flight_middleware_headers_and_rejection():
    import grpc
    import numpy as np
    import pytest
    import arrow_tpu as at
    from arrow_tpu.io.flight import (FlightServer, FlightTableClient,
                                     FlightUnauthenticated, FlightError)

    seen = []

    class Recorder:
        def start_call(self, method, metadata):
            seen.append((method, metadata.get("x-tenant")))
            return {"x-served-by": "arrow-engine"}

    class TenantGate:
        def start_call(self, method, metadata):
            if method != "Handshake" and \
                    metadata.get("x-tenant") != "good":
                raise FlightUnauthenticated("unknown tenant")

    srv = FlightServer("grpc://127.0.0.1:0",
                       middleware=(Recorder(), TenantGate()))
    srv.register("t", at.Table.from_pydict({"x": np.arange(3)}))
    try:
        cli = FlightTableClient(srv.uri)
        with pytest.raises(FlightError) as ei:
            cli.do_get("t")            # no x-tenant header
        assert ei.value.code == grpc.StatusCode.UNAUTHENTICATED
        cli.add_header("x-tenant", "good")
        assert cli.do_get("t").num_rows == 3
        assert ("DoGet", "good") in seen
        cli.close()
    finally:
        srv.shutdown()
