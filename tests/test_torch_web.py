"""The port's store UI (web.py), repl.py and report.py against the JAX
package's, on the cases of tests/test_web.py: the eight cases on the
port's server; over one store, `/`, every directory page and every file
view have the same bytes in both packages' servers, and each run's zip
the same member names and contents; `repl.last_test` loads what the JAX
package's loads; `report.to` redirects stdout as the JAX package's; and
`serve` without `--daemon` serves the store until a SIGTERM, exit 143."""

from __future__ import annotations

import io
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import zipfile
from urllib.parse import quote

import pytest

from jepsen_tpu import repl as jrepl
from jepsen_tpu import report as jreport
from jepsen_tpu import web as jweb

from jepsen_tpu_torch import repl, report, store, web
from jepsen_tpu_torch.history import invoke_op, ok_op
from test_torch_workloads import normalise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def populated_store(tmp_path):
    """tests/test_web.py's store (a valid and an invalid run), written by
    the port's store, and a third run whose verdict is unknown."""
    root = str(tmp_path / "webstore")
    hist = [invoke_op(0, "write", 1, time=1, index=0),
            ok_op(0, "write", 1, time=2, index=1)]
    for name, at, valid in (("good-test", "20260101T000000.000", True),
                            ("bad-test", "20260202T000000.000", False),
                            ("odd test", "20260303T000000.000", "unknown")):
        t = {"name": name, "start_time": at, "store_dir": root,
             "history": hist, "results": {"valid": valid}}
        store.save_1(t)
        store.save_2(t)
    return root


def start(mod, root):
    return mod.serve(host="127.0.0.1", port=0, store_dir=root)


@pytest.fixture
def server(populated_store):
    s = start(web, populated_store)
    yield s
    s.shutdown()
    s.server_close()


@pytest.fixture
def servers(populated_store):
    """The JAX package's server and the port's over one store."""
    ss = [start(jweb, populated_store), start(web, populated_store)]
    yield ss
    for s in ss:
        s.shutdown()
        s.server_close()


def get(server, path):
    url = f"http://127.0.0.1:{server.server_port}{quote(path, safe='/%')}"
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# ---------------------------------------------------------------------------
# tests/test_web.py's eight cases on the port

def test_home_table(server):
    status, body = get(server, "/")
    assert status == 200
    text = body.decode()
    assert "good-test" in text and "bad-test" in text
    assert "valid-true" in text and "valid-false" in text
    assert "valid-unknown" in text
    # newest first
    assert text.index("odd test") < text.index("bad-test") < text.index(
        "good-test")


def test_dir_browser(server):
    status, body = get(server, "/files/good-test/20260101T000000.000/")
    assert status == 200
    assert "history.txt" in body.decode()


def test_file_view(server):
    status, body = get(server,
                       "/files/good-test/20260101T000000.000/history.txt")
    assert status == 200
    assert b"write" in body


def test_zip_download(server):
    status, body = get(server, "/files/good-test/20260101T000000.000.zip")
    assert status == 200
    names = zipfile.ZipFile(io.BytesIO(body)).namelist()
    assert any(n.endswith("history.txt") for n in names)
    assert any(n.endswith("results.json") for n in names)


def test_path_traversal_forbidden(server):
    status, _ = get(server, "/files/../../etc/passwd")
    assert status == 403


def test_zip_of_whole_store_refused(server):
    status, _ = get(server, "/files/good-test.zip")
    assert status == 404
    status, _ = get(server, "/files/.zip")
    assert status in (403, 404)


def test_symlink_escape_forbidden(server, populated_store):
    os.symlink("/etc", os.path.join(populated_store, "escape"))
    status, _ = get(server, "/files/escape/hostname")
    assert status == 403


def test_missing_404(server):
    status, _ = get(server, "/files/nope/nothing")
    assert status == 404
    status, _ = get(server, "/bogus")
    assert status == 404


# ---------------------------------------------------------------------------
# both packages over one store

def paths(root) -> list:
    """Every page of the store: the table, each directory (the run
    dirs and the latest links), each file, each run's zip, and the
    refused and missing paths."""
    out = ["/", "/files/", "/bogus", "/files/nope",
           "/files/../../etc/passwd", "/files/good-test.zip",
           "/files/.zip", "/files/%2e%2e/x"]
    for d, dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        rel = "" if rel == "." else rel + "/"
        out += [f"/files/{rel}{n}/" for n in dirs]
        out += [f"/files/{rel}{n}" for n in files]
    for name, runs in store.tests(store_dir=root).items():
        out += [f"/files/{name}/{t}.zip" for t in runs]
    return sorted(set(out))


def zip_members(body: bytes) -> dict:
    z = zipfile.ZipFile(io.BytesIO(body))
    return {n: z.read(n) for n in z.namelist()}


def test_pages_equal_the_jax_package_over_one_store(servers,
                                                    populated_store):
    jsrv, tsrv = servers
    ps = paths(populated_store)
    assert len(ps) > 20
    for p in ps:
        (js, jb), (ts, tb) = get(jsrv, p), get(tsrv, p)
        assert ts == js, p
        if p.endswith(".zip") and ts == 200:
            assert zip_members(tb) == zip_members(jb), p
        else:
            assert tb == jb, p
    assert web._test_rows(populated_store) == jweb._test_rows(
        populated_store)
    assert web._home_html(populated_store) == jweb._home_html(
        populated_store)


def test_repl_last_test_matches(populated_store):
    for name in (None, "good-test", "bad-test", "nope"):
        got = repl.last_test(name, store_dir=populated_store)
        want = jrepl.last_test(name, store_dir=populated_store)
        if want is None:
            assert got is None
            continue
        assert got["name"] == want["name"]
        assert got["start_time"] == want["start_time"]
        assert normalise(got["results"]) == normalise(want["results"])
        assert [o.to_dict() for o in got["history"]] == [
            o.to_dict() for o in want["history"]]
    assert repl.last_test(store_dir=populated_store)["name"] == "odd test"


def test_report_to_redirects_stdout(tmp_path, capsys):
    for mod in (jreport, report):
        path = str(tmp_path / mod.__name__ / "deep" / "report.txt")
        with mod.to(path) as w:
            print("line one")
            print("line", 2)
            assert not w.closed
        assert open(path).read() == "line one\nline 2\n"
    err = capsys.readouterr().err.splitlines()
    assert [ln.split(" to ")[0] for ln in err] == ["Report written"] * 2


def test_serve_without_daemon_sigterm_exits_143(populated_store):
    """`python -m jepsen_tpu_torch serve --store-dir S -p 0` serves the
    store's table and files over HTTP until a SIGTERM: exit 143."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch", "serve", "--store-dir",
         populated_store, "-p", "0"], cwd=REPO, env=env,
        stderr=subprocess.PIPE, text=True)
    ports: list = []
    up = threading.Event()

    def read():
        for line in proc.stderr:
            m = re.search(r"Listening on http://[^:]+:(\d+)/", line)
            if m and not ports:
                ports.append(int(m.group(1)))
                up.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        assert up.wait(timeout=120), "serve never listened"
        base = f"http://127.0.0.1:{ports[0]}"
        with urllib.request.urlopen(base + "/", timeout=30) as r:
            assert r.status == 200 and b"good-test" in r.read()
        with urllib.request.urlopen(
                base + "/files/bad-test/20260202T000000.000/results.json",
                timeout=30) as r:
            assert b"false" in r.read()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 143
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
        proc.stderr.close()
