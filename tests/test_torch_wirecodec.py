"""The port's TKW1 wire codec (``tpukube_torch/sched/wirecodec.py``) and
its negotiation over the process transport, held against the reference's.

Twins (``run_twin``, both packages, decision by decision): every test of
test_wirecodec.py, its pure round-trip, fuzz and bound tests and its
tests over real worker daemons (the reference's spawn ``tpukube.cli
shard-worker``, the port's ``tpukube_torch.cli shard-worker``). A worker
that cannot spawn fails the port's run: the reference's skip mark is not
applied to a twin. The port's own: the same bodies encode to the same
frames on both packages, and each package decodes the other's frames."""

import contextlib
import json
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import test_wirecodec
from tpukube.sched import wirecodec as ref_wirecodec
from tpukube_torch.sched import wirecodec
from torch_refnative import use_private_tpuinfo
from torch_twin import reference_cases, run_twin, value_fixtures

use_private_tpuinfo()


@contextlib.contextmanager
def _json_only_server():
    """test_wirecodec.py's ``json_only_server`` fixture: a pre-codec peer
    that answers compact JSON to everything and ignores Accept (a fresh
    one for each side of a twin)."""

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            if body.startswith(b"TKW1"):
                self.send_response(400)
                self.end_headers()
                return
            doc = json.loads(body) if body else {}
            out = json.dumps({"echo": doc}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()


FIXTURES = {"json_only_server": lambda g: _json_only_server()}


@pytest.mark.parametrize("fn,params", reference_cases(test_wirecodec, {}))
def test_reference_wirecodec_tests_hold_on_the_port(fn, params):
    run_twin(fn, {**FIXTURES, **value_fixtures(params)})


@pytest.mark.parametrize("seed", [0, 7, 1337])
@pytest.mark.parametrize("compress_min", [0, 1024, 1 << 30])
def test_frames_are_byte_equal_across_packages(seed, compress_min):
    # the same body is the same frame on both packages (zlib level 1 on
    # both), and each package decodes the other's frame back to it
    for op, body in test_wirecodec._op_bodies(seed).items():
        got, raw = wirecodec.encode_frame(body, compress_min)
        want, ref_raw = ref_wirecodec.encode_frame(body, compress_min)
        assert (got, raw) == (want, ref_raw), op
        assert wirecodec.decode_frame_ex(want) == \
            ref_wirecodec.decode_frame_ex(got)
        assert wirecodec.dumps_json(body) == ref_wirecodec.dumps_json(body)


def test_garbage_frames_fail_alike_on_both_packages():
    # a mutated frame decodes to the same value on both packages or fails
    # on both with the same message
    rng = random.Random(99)
    frame, _ = wirecodec.encode_frame(test_wirecodec._op_bodies(3)["admit"],
                                      1 << 30)
    for _ in range(300):
        mutated = bytearray(frame)
        for _ in range(rng.randint(1, 3)):
            mutated[rng.randrange(len(mutated))] = rng.randrange(256)
        outcomes = []
        for mod, err in ((wirecodec, wirecodec.WireCodecError),
                         (ref_wirecodec, ref_wirecodec.WireCodecError)):
            try:
                outcomes.append(("ok", mod.decode_frame(bytes(mutated))))
            except err as e:
                outcomes.append(("error", str(e)))
        assert outcomes[0] == outcomes[1]
