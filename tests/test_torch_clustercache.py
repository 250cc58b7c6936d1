"""The cluster tier of the compile cache, the port's against the JAX
package's.

The cases of tests/test_clustercache.py that the port carries (:143-532,
:889-1065; the scheduler's warm placement and the victim costs are not
queued), by their names: the warm-keys annotation encoded by either
package and parsed by the other byte for byte, the `fps/` markers and
their scan, `peers.json` (written by either advertiser, read by either
fetcher, stale and torn files read as no peers), the peer fetch over live
HTTP in both directions (the port's fetcher against the JAX serving read,
and the JAX fetcher against the port's), a dead peer, a corrupt payload,
the breaker, no peers file meaning no fetch I/O, the `cache.fetch` and
`cache.advertise` failpoints and a crashed fetcher's lease taken over by
another process; the gate contracts of the runtime client, Allocate and
the device plugin's command; the exporter's `/cache/entry` route as a
subprocess, with its token, gate on and off; and the fetch counters in
the node's render.
"""

from __future__ import annotations

import ast
import copy
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import pytest

from vtpu_manager.client.fake import FakeKubeClient as JaxFakeClient
from vtpu_manager.clustercache import advertise as jadv
from vtpu_manager.clustercache import fetch as jfetch
from vtpu_manager.compilecache import cache as jcache
from vtpu_manager.resilience import failpoints as jfp
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.client.kube import KubeError
from vtpu_manager_torch.clustercache import advertise as tadv
from vtpu_manager_torch.clustercache import fetch as tfetch
from vtpu_manager_torch.compilecache import cache as tcache
from vtpu_manager_torch.resilience import failpoints as tfp
from vtpu_manager_torch.resilience.failpoints import CrashFailpoint
from vtpu_manager_torch.util import consts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY_A = "a" * 64
KEY_B = "b" * 64
# (advertise module, fetch module, store module) of each package
PKGS = {"jax": (jadv, jfetch, jcache), "port": (tadv, tfetch, tcache)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def unwrap(raw: bytes) -> bytes | None:
    """An entry's payload, verified by the port's store."""
    return tcache.CompileCache._verify(raw)


def serve_root(read_entry, root: str):
    """A /cache/entry server over one store root through `read_entry` (a
    package's `read_entry_for_serving`): (endpoint, counter, server)."""
    counter = {"requests": 0}

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            counter["requests"] += 1
            key = (parse_qs(urlparse(self.path).query).get("key") or [""])[0]
            raw = read_entry(root, key)
            if raw is None:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"127.0.0.1:{srv.server_port}", counter, srv


def write_peers(root, key, endpoint, node="peer-0", ts=None):
    doc = {"ts": time.time() if ts is None else ts,
           "peers": [{"node": node, "endpoint": endpoint,
                      "keys": {key: "prog"}}]}
    with open(os.path.join(root, consts.CACHE_PEERS_NAME), "w") as f:
        json.dump(doc, f)


@pytest.fixture
def armed_failpoints():
    tfp.enable(seed=7)
    yield
    tfp.disable()


def never():
    raise AssertionError("a cold node with a warm peer must not compile")


# ---------------------------------------------------------------------------
# the annotation
# ---------------------------------------------------------------------------

class TestAdvertiseCodec:
    def test_roundtrip(self):
        now = round(time.time(), 3)
        pairs = (("prog-a", KEY_A), ("prog-b", KEY_B))
        mine = tadv.NodeWarmKeys("10.0.0.5:9394", pairs, now)
        theirs = jadv.NodeWarmKeys("10.0.0.5:9394", pairs, now)
        assert mine.encode() == theirs.encode()
        # each package parses the other's bytes to the same advertisement
        got = jadv.parse_warm_keys(mine.encode(), now=now + 1)
        assert (got.endpoint, got.pairs, got.ts) == \
            ("10.0.0.5:9394", pairs, now)
        assert tadv.parse_warm_keys(theirs.encode(), now=now + 1) == mine

    def test_bounds_and_order_preserved(self):
        now = time.time()
        pairs = tuple((f"fp{i}", ("%02x" % i) * 32)
                      for i in range(tadv.MAX_AD_KEYS + 4))
        assert tadv.parse_warm_keys(tadv.NodeWarmKeys(
            "h:1", pairs, now).encode(), now=now).pairs == pairs
        over = tuple((f"fp{i}", ("%02x" % (i % 256)) * 32)
                     for i in range(tadv.MAX_AD_KEYS_LIMIT + 4))
        raw = tadv.NodeWarmKeys("h:1", over, now).encode()
        got = tadv.parse_warm_keys(raw, now=now)
        assert got.pairs == over[:tadv.MAX_AD_KEYS_LIMIT]
        assert got.pairs == jadv.parse_warm_keys(raw, now=now).pairs
        assert (tadv.MAX_AD_KEYS, tadv.MAX_AD_KEYS_LIMIT, tadv.MAX_AD_LEN,
                tadv.MAX_AD_AGE_S, tadv.PEERS_STALE_S) == \
            (jadv.MAX_AD_KEYS, jadv.MAX_AD_KEYS_LIMIT, jadv.MAX_AD_LEN,
             jadv.MAX_AD_AGE_S, jadv.PEERS_STALE_S)

    def test_staleness_and_garbage(self):
        now = time.time()
        enc = tadv.NodeWarmKeys("h:1", (("fp", KEY_A),), now).encode()
        raws = [enc, None, "", "garbage", f"no-pipe@{now}",
                f"h:1|fp={KEY_A}@nan", f"h:1|fp={KEY_A}@inf",
                "x" * (tadv.MAX_AD_LEN + 1), f"|fp={KEY_A}@{now:.3f}",
                f"h:1|@{now:.3f}"]
        for at in (now, now + tadv.MAX_AD_AGE_S + 10, now - 60):
            for raw in raws:
                mine = tadv.parse_warm_keys(raw, now=at)
                theirs = jadv.parse_warm_keys(raw, now=at)
                assert (mine is None) == (theirs is None), (raw, at)
                if mine is not None:
                    assert (mine.endpoint, mine.pairs) == \
                        (theirs.endpoint, theirs.pairs)
        assert tadv.parse_warm_keys(enc, now=now) is not None
        assert tadv.parse_warm_keys(
            enc, now=now + tadv.MAX_AD_AGE_S + 10) is None

    def test_malformed_pair_skipped_not_fatal(self):
        now = time.time()
        raw = (f"h:1|fp-good={KEY_A},bad-key=zz,=nokey,"
               f"we/ird={KEY_B}@{now:.3f}")
        assert tadv.parse_warm_keys(raw, now=now).pairs == \
            jadv.parse_warm_keys(raw, now=now).pairs == (("fp-good", KEY_A),)

    def test_port_annotation_scores_in_the_jax_scheduler(self, tmp_path):
        """What the port's advertiser publishes is what the JAX
        scheduler's `warm_term` and `parse_warm_keys` read."""
        root = str(tmp_path / "cc")
        tcache.CompileCache(root).put(KEY_A, b"exe")
        tadv.record_fingerprint(root, "prog", KEY_A)
        client = FakeKubeClient()
        client.add_node({"metadata": {"name": "node-0", "annotations": {}}})
        tadv.CacheAdvertiser(client, "node-0", root,
                             endpoint="10.0.0.5:9394").publish_once()
        raw = client.get_node("node-0")["metadata"]["annotations"][
            consts.node_cache_keys_annotation()]
        warm = jadv.parse_warm_keys(raw)
        assert warm.endpoint == "10.0.0.5:9394"
        assert warm.pairs == (("prog", KEY_A),)
        assert jadv.warm_term(warm, "prog") == jadv.WARM_SCORE_WEIGHT
        assert jadv.warm_term(warm, "other") == 0.0

    def test_markers_and_scan(self, tmp_path, pkg):
        adv, _, store = pkg
        root = str(tmp_path / "cc")
        cc = store.CompileCache(root)
        cc.put(KEY_A, b"exe-a")
        cc.put(KEY_B, b"exe-b")
        adv.record_fingerprint(root, "prog-a", KEY_A)
        time.sleep(0.02)
        adv.record_fingerprint(root, "prog-b", KEY_B)
        # hottest first, as either package scans the markers
        for other in (tadv, jadv):
            assert other.scan_warm_pairs(root) == \
                [("prog-b", KEY_B), ("prog-a", KEY_A)]
        time.sleep(0.02)
        adv.record_fingerprint(root, "prog-a", KEY_A)
        assert tadv.scan_warm_pairs(root)[0] == ("prog-a", KEY_A)
        # a marker whose entry was evicted is not advertised
        os.unlink(cc.entry_path(KEY_B))
        assert tadv.scan_warm_pairs(root) == jadv.scan_warm_pairs(root) == \
            [("prog-a", KEY_A)]
        adv.record_fingerprint(root, 'we"ird/', KEY_A)
        adv.record_fingerprint(root, '"//"', KEY_A)
        adv.record_fingerprint(root, "ok", "not-a-key")
        assert set(os.listdir(os.path.join(root, tadv.FPS_SUBDIR))) == \
            {"weird", "prog-a", "prog-b"}
        assert tadv.FPS_SUBDIR == jadv.FPS_SUBDIR


# ---------------------------------------------------------------------------
# the advertiser and peers.json
# ---------------------------------------------------------------------------

class TestAdvertiser:
    @staticmethod
    def _fleet(tmp_path, n=3, client=None):
        client = client or FakeKubeClient()
        roots = []
        for i in range(n):
            root = str(tmp_path / f"node-{i}" / "cc")
            os.makedirs(root, exist_ok=True)
            roots.append(root)
            client.add_node({"metadata": {"name": f"node-{i}",
                                          "annotations": {}}})
        return client, roots

    def test_publish_patches_annotation(self, tmp_path):
        client, roots = self._fleet(tmp_path, n=1)
        tcache.CompileCache(roots[0]).put(KEY_A, b"exe")
        tadv.record_fingerprint(roots[0], "prog", KEY_A)
        ad = tadv.CacheAdvertiser(client, "node-0", roots[0],
                                  endpoint="1.2.3.4:9394").publish_once()
        raw = client.get_node("node-0")["metadata"]["annotations"][
            consts.node_cache_keys_annotation()]
        assert raw == ad.encode()
        w = tadv.parse_warm_keys(raw)
        assert (w.endpoint, w.pairs) == ("1.2.3.4:9394", (("prog", KEY_A),))

    def test_publish_bounds_pairs_to_max_keys(self, tmp_path):
        client, roots = self._fleet(tmp_path, n=1)
        cc = tcache.CompileCache(roots[0])
        for i in range(5):
            key = f"{i:x}" * 64
            cc.put(key, b"exe")
            tadv.record_fingerprint(roots[0], f"prog{i}", key)
            time.sleep(0.01)
        for asked, got in ((2, 2), (0, 1), (99, 5)):
            adv = tadv.CacheAdvertiser(client, "node-0", roots[0],
                                       endpoint="h:1", max_keys=asked)
            assert len(adv.publish_once().pairs) == got
        # hottest first: the last marker written leads
        assert adv.advertisement().pairs[0] == ("prog4", "4" * 64)

    def test_fan_in_excludes_self_and_fetchless(self, tmp_path):
        client, roots = self._fleet(tmp_path, n=3)
        now = time.time()
        client.patch_node_annotations("node-1", {
            consts.node_cache_keys_annotation():
                tadv.NodeWarmKeys("9.9.9.9:1", (("prog", KEY_A),),
                                  now).encode()})
        client.patch_node_annotations("node-2", {
            consts.node_cache_keys_annotation():
                tadv.NodeWarmKeys("", (("prog", KEY_B),), now).encode()})
        adv = tadv.CacheAdvertiser(client, "node-0", roots[0],
                                   endpoint="1.1.1.1:1")
        assert adv.refresh_peers() == 1
        peers = tadv.read_peers(roots[0])
        assert [p["node"] for p in peers] == ["node-1"]
        assert peers[0]["keys"] == {KEY_A: "prog"}

    def test_peers_file_is_the_jax_advertisers(self, tmp_path):
        """The same fleet fanned in by either advertiser: the same bytes
        in peers.json, and each package's fetcher reads either file."""
        now = 1_700_000_000.0
        docs = {}
        for name, client_cls, adv in (("port", FakeKubeClient, tadv),
                                      ("jax", JaxFakeClient, jadv)):
            client, roots = self._fleet(tmp_path / name, n=3,
                                        client=client_cls())
            client.patch_node_annotations("node-1", {
                consts.node_cache_keys_annotation():
                    f"10.0.0.1:9394|prog={KEY_A},other={KEY_B}@{now:.3f}"})
            client.patch_node_annotations("node-2", {
                consts.node_cache_keys_annotation(): "garbage"})
            adv.CacheAdvertiser(client, "node-0", roots[0]).refresh_peers(
                now=now + 1)
            with open(os.path.join(roots[0], consts.CACHE_PEERS_NAME)) as f:
                docs[name] = f.read()
            for reader in (tadv, jadv):
                assert reader.read_peers(roots[0], now=now + 2) == [
                    {"node": "node-1", "endpoint": "10.0.0.1:9394",
                     "keys": {KEY_A: "prog", KEY_B: "other"}}]
        assert docs["port"] == docs["jax"]

    def test_read_peers_staleness_and_garbage(self, tmp_path, pkg):
        adv = pkg[0]
        root = str(tmp_path / "cc")
        os.makedirs(root)
        path = os.path.join(root, consts.CACHE_PEERS_NAME)
        assert adv.read_peers(root) == []
        for body in ("{torn", "[1, 2]", json.dumps({"ts": "x"}),
                     json.dumps({"ts": "nan", "peers": [{"node": "x"}]}),
                     json.dumps({"ts": time.time() - tadv.PEERS_STALE_S
                                 - 60, "peers": [{"node": "x"}]}),
                     json.dumps({"ts": time.time() + 60,
                                 "peers": [{"node": "x"}]}),
                     json.dumps({"ts": time.time(), "peers": "x"})):
            with open(path, "w") as f:
                f.write(body)
            assert adv.read_peers(root) == [], body
        with open(path, "w") as f:
            json.dump({"ts": time.time(), "peers": [{"node": "x"}]}, f)
        assert adv.read_peers(root) == [{"node": "x"}]

    def test_advertise_failpoint_decays_to_no_signal(self, tmp_path,
                                                     armed_failpoints):
        client, roots = self._fleet(tmp_path, n=1)
        adv = tadv.CacheAdvertiser(client, "node-0", roots[0],
                                   endpoint="h:1")
        tfp.arm("cache.advertise", "error", count=1)
        with pytest.raises(KubeError):
            adv.publish_once()
        anns = client.get_node("node-0")["metadata"]["annotations"]
        assert consts.node_cache_keys_annotation() not in anns
        adv.publish_once()
        assert consts.node_cache_keys_annotation() in \
            client.get_node("node-0")["metadata"]["annotations"]

    def test_daemon_ticks_publish_and_fan_in(self, tmp_path):
        client, roots = self._fleet(tmp_path, n=2)
        tcache.CompileCache(roots[1]).put(KEY_A, b"exe")
        tadv.record_fingerprint(roots[1], "prog", KEY_A)
        advs = [tadv.CacheAdvertiser(client, f"node-{i}", roots[i],
                                     endpoint=f"127.0.0.1:{i + 1}",
                                     interval_s=0.05) for i in range(2)]
        for adv in advs:
            adv.start()
        try:
            deadline = time.monotonic() + 10
            while not tadv.read_peers(roots[0]) and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
        finally:
            for adv in advs:
                adv.stop()
        assert tadv.read_peers(roots[0]) == [
            {"node": "node-1", "endpoint": "127.0.0.1:2",
             "keys": {KEY_A: "prog"}}]
        assert not any(a._thread.is_alive() for a in advs)


# ---------------------------------------------------------------------------
# the peer fetch, over live HTTP
# ---------------------------------------------------------------------------

class TestPeerFetch:
    def test_cold_node_fetches_instead_of_compiling(self, tmp_path):
        seed_root = str(tmp_path / "warm" / "cc")
        cold_root = str(tmp_path / "cold" / "cc")
        os.makedirs(cold_root)
        tcache.CompileCache(seed_root).put(KEY_A, b"the-executable")
        endpoint, counter, srv = serve_root(tfetch.read_entry_for_serving,
                                            seed_root)
        try:
            write_peers(cold_root, KEY_A, endpoint)
            cc = tfetch.ClusterCompileCache(cold_root)
            assert cc.get_or_compile(KEY_A, never, fingerprint="prog") == \
                (b"the-executable", "fetch")
            assert counter["requests"] == 1
            assert (cc.stats.peer_fetches, cc.stats.peer_fetch_failures) == \
                (1, 0)
            # the entry landed: the next tenant is a local hit, and the
            # node advertises it onward
            assert cc.get_or_compile(KEY_A, never)[1] == "hit"
            assert counter["requests"] == 1
            assert tadv.scan_warm_pairs(cold_root) == [("prog", KEY_A)]
            assert os.listdir(cc.tmp_dir) == []
        finally:
            srv.shutdown()

    @pytest.mark.parametrize("fetcher,server", [("port", "jax"),
                                                ("jax", "port")])
    def test_entries_cross_between_the_packages(self, tmp_path, fetcher,
                                                server):
        """One package's fetcher downloads what the other's serving read
        serves, and lands an entry both stores read."""
        f_adv, f_fetch, _ = PKGS[fetcher]
        _, s_fetch, s_store = PKGS[server]
        seed_root = str(tmp_path / "warm" / "cc")
        cold_root = str(tmp_path / "cold" / "cc")
        os.makedirs(cold_root)
        payload = bytes(range(256)) * 64
        s_store.CompileCache(seed_root).put(KEY_A, payload)
        endpoint, counter, srv = serve_root(s_fetch.read_entry_for_serving,
                                            seed_root)
        try:
            write_peers(cold_root, KEY_A, endpoint)
            cc = f_fetch.ClusterCompileCache(cold_root)
            assert cc.get_or_compile(KEY_A, never, fingerprint="prog") == \
                (payload, "fetch")
            assert counter["requests"] == 1
            for store in (tcache, jcache):
                assert store.CompileCache(cold_root).get(KEY_A) == payload
            assert f_adv.scan_warm_pairs(cold_root) == [("prog", KEY_A)]
        finally:
            srv.shutdown()

    def test_dead_peer_falls_open_to_compile(self, tmp_path):
        root = str(tmp_path / "cc")
        os.makedirs(root)
        write_peers(root, KEY_A, "127.0.0.1:1")
        cc = tfetch.ClusterCompileCache(root, fetch_timeout_s=0.5)
        assert cc.get_or_compile(KEY_A, lambda: b"local") == \
            (b"local", "miss")
        assert cc.stats.peer_fetch_failures == 1

    def test_corrupt_served_payload_never_lands(self, tmp_path):
        root = str(tmp_path / "cc")
        os.makedirs(root)

        class Garbage(BaseHTTPRequestHandler):
            def do_GET(self):
                body = b"\x00garbage-not-an-entry"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        srv = ThreadingHTTPServer(("127.0.0.1", 0), Garbage)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            write_peers(root, KEY_A, f"127.0.0.1:{srv.server_port}")
            cc = tfetch.ClusterCompileCache(root)
            assert cc.get_or_compile(KEY_A, lambda: b"real") == \
                (b"real", "miss")
            assert cc.stats.peer_fetch_failures == 1
            assert cc.get(KEY_A) == b"real"
            assert os.listdir(cc.tmp_dir) == []
        finally:
            srv.shutdown()

    def test_breaker_stops_hammering_dead_peer(self, tmp_path):
        root = str(tmp_path / "cc")
        os.makedirs(root)
        cc = tfetch.ClusterCompileCache(root, fetch_timeout_s=0.2)
        for _ in range(4):
            write_peers(root, KEY_A, "127.0.0.1:1")
            assert cc._fetch_remote(KEY_A) is None
        assert not cc._breaker("127.0.0.1:1").allow()
        before = cc.stats.peer_fetch_failures
        assert cc._fetch_remote(KEY_A) is None
        assert cc.stats.peer_fetch_failures == before

    def test_peers_are_tried_in_order_up_to_the_bound(self, tmp_path):
        """A key advertised by several peers: dead ones cost a rung each,
        at most MAX_PEERS_TRIED, and the first that serves it wins."""
        seed_root = str(tmp_path / "warm" / "cc")
        tcache.CompileCache(seed_root).put(KEY_A, b"exe")
        endpoint, counter, srv = serve_root(tfetch.read_entry_for_serving,
                                            seed_root)
        root = str(tmp_path / "cold" / "cc")
        os.makedirs(root)
        try:
            for live_at, outcome in ((1, "fetch"), (3, "miss")):
                peers = [{"node": f"dead-{i}", "endpoint": f"127.0.0.1:{i + 1}",
                          "keys": {KEY_A: "p"}} for i in range(live_at)]
                peers.append({"node": "live", "endpoint": endpoint,
                              "keys": {KEY_A: "p"}})
                with open(os.path.join(root, consts.CACHE_PEERS_NAME),
                          "w") as f:
                    json.dump({"ts": time.time(), "peers": peers}, f)
                cc = tfetch.ClusterCompileCache(root, fetch_timeout_s=0.5)
                assert cc.get_or_compile(KEY_A, lambda: b"local")[1] == \
                    outcome
                assert cc.stats.peer_fetch_failures == min(
                    live_at, tfetch.MAX_PEERS_TRIED)
                os.unlink(cc.entry_path(KEY_A))
        finally:
            srv.shutdown()
        assert counter["requests"] == 1

    def test_no_peers_file_zero_fetch_io(self, tmp_path):
        seed_root = str(tmp_path / "warm" / "cc")
        tcache.CompileCache(seed_root).put(KEY_A, b"exe")
        endpoint, counter, srv = serve_root(tfetch.read_entry_for_serving,
                                            seed_root)
        try:
            root = str(tmp_path / "cold" / "cc")
            os.makedirs(root)
            cc = tfetch.ClusterCompileCache(root)
            assert cc.get_or_compile(KEY_A, lambda: b"local")[1] == "miss"
            assert counter["requests"] == 0
            # nor does the node-local store ever ask, peers file or not
            write_peers(root, KEY_B, endpoint)
            plain = tcache.CompileCache(root)
            assert plain._fetch_remote(KEY_B) is None
            assert plain.get_or_compile(KEY_B, lambda: b"l")[1] == "miss"
            assert counter["requests"] == 0
        finally:
            srv.shutdown()

    def test_serving_read_verifies_and_quarantines(self, tmp_path, pkg):
        _, fetch, store = pkg
        root = str(tmp_path / "cc")
        cc = store.CompileCache(root)
        cc.put(KEY_A, b"exe")
        raw = fetch.read_entry_for_serving(root, KEY_A)
        assert unwrap(raw) == b"exe"
        assert raw == tfetch.read_entry_for_serving(root, KEY_A) == \
            jfetch.read_entry_for_serving(root, KEY_A)
        assert fetch.read_entry_for_serving(root, "../" + KEY_A[3:]) is None
        assert fetch.read_entry_for_serving(root, "") is None
        assert fetch.read_entry_for_serving(root, KEY_A.upper()) is None
        with open(cc.entry_path(KEY_B), "wb") as f:
            f.write(b"torn")
        assert fetch.read_entry_for_serving(root, KEY_B) is None
        assert not os.path.exists(cc.entry_path(KEY_B))
        assert len(os.listdir(cc.quarantine_dir)) == 1

    def test_valid_entry_key_is_the_jax_rule(self):
        for key in (KEY_A, KEY_A.upper(), KEY_A[:63], KEY_A + "0", "",
                    None, "../" + KEY_A[3:], "g" * 64, "0123456789abcdef" * 4):
            assert tadv.valid_entry_key(key) == jadv.valid_entry_key(key)


# ---------------------------------------------------------------------------
# faults: the failpoints, a torn fetch, a crashed fetcher
# ---------------------------------------------------------------------------

def _fire_calls(path: str) -> dict[str, set[frozenset]]:
    with open(path) as f:
        tree = ast.parse(f.read())
    out: dict[str, set[frozenset]] = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "fire"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "failpoints"):
            out.setdefault(node.args[0].value, set()).add(
                frozenset(k.arg for k in node.keywords))
    return out


class TestChaosFetch:
    @pytest.mark.parametrize("module", ["advertise.py", "fetch.py"])
    def test_sites_fire_where_and_with_the_keys_jax_fires(self, module):
        mine = _fire_calls(os.path.join(REPO, "vtpu_manager_torch",
                                        "clustercache", module))
        theirs = _fire_calls(os.path.join(REPO, "vtpu_manager",
                                          "clustercache", module))
        assert mine == theirs
        assert set(mine) <= set(tfp.SITES) == set(jfp.SITES)

    def test_injected_error_falls_open_to_compile(self, tmp_path,
                                                  armed_failpoints):
        seed_root = str(tmp_path / "warm" / "cc")
        tcache.CompileCache(seed_root).put(KEY_A, b"exe")
        endpoint, _c, srv = serve_root(tfetch.read_entry_for_serving,
                                       seed_root)
        try:
            root = str(tmp_path / "cold" / "cc")
            os.makedirs(root)
            write_peers(root, KEY_A, endpoint)
            cc = tfetch.ClusterCompileCache(root)
            tfp.arm("cache.fetch", "error", count=1)
            assert cc.get_or_compile(KEY_A, lambda: b"local") == \
                (b"local", "miss")
            assert cc.stats.peer_fetch_failures == 1
            assert tfp.stats()["fires"]["cache.fetch"] == 1
            os.unlink(cc.entry_path(KEY_A))
            assert cc.get_or_compile(KEY_A, lambda: b"x")[1] == "fetch"
        finally:
            srv.shutdown()

    def test_torn_fetch_never_served(self, tmp_path, armed_failpoints):
        seed_root = str(tmp_path / "warm" / "cc")
        tcache.CompileCache(seed_root).put(KEY_A, b"X" * 4096)
        endpoint, _c, srv = serve_root(tfetch.read_entry_for_serving,
                                       seed_root)
        try:
            root = str(tmp_path / "cold" / "cc")
            os.makedirs(root)
            write_peers(root, KEY_A, endpoint)
            cc = tfetch.ClusterCompileCache(root)
            tfp.arm("cache.fetch", "partial-write", count=1)
            with pytest.raises(CrashFailpoint):
                cc.get_or_compile(KEY_A, lambda: b"never")
            assert os.listdir(cc.entries_dir) == []
            assert cc.get(KEY_A) is None
            orphans = os.listdir(cc.tmp_dir)
            assert len(orphans) == 1 and ".fetch." in orphans[0]
            # the evictor reaps the crashed fetcher's staging
            cc2 = tcache.CompileCache(root, stale_lease_s=0.0)
            cc2.evict(budget_bytes=1 << 30, now=time.time() + 10)
            assert os.listdir(cc2.tmp_dir) == []
        finally:
            srv.shutdown()

    @pytest.mark.parametrize("successor", ["port", "jax"])
    def test_crashed_fetcher_lease_taken_over(self, tmp_path, successor):
        """The port's fetcher dies mid-download (its staging torn, its
        lease's flock released by the kernel); a successor of either
        package takes the lease over within the stale budget and seeds
        the node from the same peer."""
        seed_root = str(tmp_path / "warm" / "cc")
        tcache.CompileCache(seed_root).put(KEY_A, b"the-artifact")
        endpoint, _c, srv = serve_root(tfetch.read_entry_for_serving,
                                       seed_root)
        root = str(tmp_path / "cold" / "cc")
        os.makedirs(root)
        write_peers(root, KEY_A, endpoint)
        crasher = (
            "import os, sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from vtpu_manager_torch.resilience import failpoints\n"
            "from vtpu_manager_torch.clustercache import "
            "ClusterCompileCache\n"
            "failpoints.enable(seed=1)\n"
            "failpoints.arm('cache.fetch', 'partial-write', count=1)\n"
            f"cc = ClusterCompileCache({root!r})\n"
            "try:\n"
            f"    cc.get_or_compile({KEY_A!r}, lambda: b'never')\n"
            "except BaseException:\n"
            "    os._exit(0)\n"
            "os._exit(3)\n")
        try:
            res = subprocess.run([sys.executable, "-c", crasher], timeout=60)
            assert res.returncode == 0
            cc = PKGS[successor][1].ClusterCompileCache(root,
                                                         stale_lease_s=1.0)
            assert os.listdir(cc.lease_dir)
            t0 = time.monotonic()
            assert cc.get_or_compile(KEY_A, never, timeout_s=30) == \
                (b"the-artifact", "fetch")
            assert time.monotonic() - t0 < 6.0
        finally:
            srv.shutdown()


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

class TestGateContracts:
    def test_runtime_client_constructs_cluster_tier(self, tmp_path,
                                                    monkeypatch):
        from vtpu_manager_torch.runtime import client as rt
        monkeypatch.setenv(consts.ENV_COMPILE_CACHE, "true")
        monkeypatch.setenv(consts.ENV_COMPILE_CACHE_DIR,
                           str(tmp_path / "cc"))
        monkeypatch.setenv(consts.ENV_CLUSTER_CACHE, "true")
        monkeypatch.setenv(consts.ENV_CACHE_PEER_TOKEN, "peer-secret")
        rt._reset_compile_cache()
        try:
            cc = rt.compile_cache()
            assert isinstance(cc, tfetch.ClusterCompileCache)
            assert cc.token == "peer-secret"
        finally:
            rt._reset_compile_cache()

    @pytest.mark.parametrize("value", [None, "false", "1"])
    def test_runtime_client_gate_off_plain_node_cache(self, tmp_path,
                                                      monkeypatch, value):
        from vtpu_manager_torch.runtime import client as rt
        monkeypatch.setenv(consts.ENV_COMPILE_CACHE, "true")
        monkeypatch.setenv(consts.ENV_COMPILE_CACHE_DIR,
                           str(tmp_path / "cc"))
        if value is None:
            monkeypatch.delenv(consts.ENV_CLUSTER_CACHE, raising=False)
        else:
            monkeypatch.setenv(consts.ENV_CLUSTER_CACHE, value)
        rt._reset_compile_cache()
        try:
            cc = rt.compile_cache()
            assert type(cc) is tcache.CompileCache
            cc.get_or_compile("k", lambda: b"exe")
            assert not os.path.exists(
                os.path.join(str(tmp_path / "cc"), tadv.FPS_SUBDIR))
            assert cc._fetch_remote("k") is None
        finally:
            rt._reset_compile_cache()

    def test_runtime_client_cluster_tier_needs_the_node_cache(
            self, tmp_path, monkeypatch):
        from vtpu_manager_torch.runtime import client as rt
        monkeypatch.delenv(consts.ENV_COMPILE_CACHE, raising=False)
        monkeypatch.setenv(consts.ENV_COMPILE_CACHE_DIR, str(tmp_path))
        monkeypatch.setenv(consts.ENV_CLUSTER_CACHE, "true")
        rt._reset_compile_cache()
        try:
            assert rt.compile_cache() is None
            assert not os.listdir(tmp_path)
        finally:
            rt._reset_compile_cache()

    @pytest.mark.parametrize("cc_on,cluster_on", [(True, True),
                                                  (True, False),
                                                  (False, True)])
    def test_vnum_injects_cluster_env_only_when_gated(self, tmp_path,
                                                      cc_on, cluster_on):
        """The port's Allocate and the JAX plugin's, both gates set alike:
        `VTPU_CLUSTER_CACHE=true` only on top of the armed node cache,
        and the same config bytes."""
        from test_torch_compilecache import _config_bytes
        from test_torch_deviceplugin import (alloc, committed_pod,
                                             jax_plugin, make_manager,
                                             node_dirs)

        from vtpu_manager.deviceplugin.api import deviceplugin_pb2 as jpb
        from vtpu_manager_torch.config.node_config import NodeConfig
        from vtpu_manager_torch.deviceplugin.vnum import (VnumPlugin,
                                                          device_id)
        client = FakeKubeClient()
        mgr = make_manager(client)
        plugin = VnumPlugin(mgr, client, "node-1", node_config=NodeConfig(),
                            **node_dirs(tmp_path / "port"))
        jp, jclient = jax_plugin(mgr, tmp_path / "jax")
        for p in (plugin, jp):
            p.compile_cache_enabled = cc_on
            p.cluster_cache_enabled = cluster_on
        pod = committed_pod(mgr, cores=50, memory=2 << 30)
        client.add_pod(copy.deepcopy(pod))
        jclient.add_pod(copy.deepcopy(pod))
        ids = [device_id(mgr.chips[0].uuid, 0)]
        mine = alloc(plugin, *ids)
        theirs = jp.allocate(jpb.AllocateRequest(container_requests=[
            jpb.ContainerAllocateRequest(devicesIDs=ids)])
        ).container_responses[0]
        want = "true" if cc_on and cluster_on else None
        assert mine.envs.get(consts.ENV_CLUSTER_CACHE) == want
        assert dict(theirs.envs).get(consts.ENV_CLUSTER_CACHE) == want
        assert _config_bytes(plugin.base_dir) == _config_bytes(jp.base_dir)

    def test_plugin_gate_without_compile_cache_stays_off(self, tmp_path):
        from test_torch_entry import ENTRY, _serve_until, private_flags
        log = _serve_until(ENTRY + private_flags(tmp_path) + [
            "--fake-chips", "1", "--fake-client", "--feature-gates",
            "ClusterCompileCache=true"], "device plugin running on")
        assert "ClusterCompileCache=true requires CompileCache=true" in log
        assert "cluster cache advertiser running" not in log

    def test_plugin_gate_starts_the_advertiser(self, tmp_path):
        from test_torch_entry import ENTRY, _serve_until, private_flags
        log = _serve_until(ENTRY + private_flags(tmp_path) + [
            "--fake-chips", "1", "--fake-client", "--feature-gates",
            "CompileCache=true,ClusterCompileCache=true",
            "--cache-advertise-endpoint", "127.0.0.1:9394",
            "--cache-ad-max-pairs", "40"], "device plugin running on")
        assert "cluster cache advertiser running (endpoint " \
            "'127.0.0.1:9394')" in log
        assert "--cache-ad-max-pairs=40 outside 1..32; clamping" in log
        assert "requires CompileCache" not in log


# ---------------------------------------------------------------------------
# the exporter's /cache/entry
# ---------------------------------------------------------------------------

def _get_raw(url: str, token: str | None = None) -> tuple[int, bytes]:
    req = urllib.request.Request(url)
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class TestMonitorRoute:
    TOKEN = "peer-token"

    @pytest.fixture(params=[True, False], ids=["gate_on", "gate_off"])
    def exporter(self, request, tmp_path):
        from test_torch_device_monitor import Exporter, node_dir
        node_dir(tmp_path)
        cc = tcache.CompileCache(str(tmp_path / "mgr" /
                                     consts.COMPILE_CACHE_SUBDIR))
        cc.put(KEY_A, b"served-exe")
        with open(cc.entry_path(KEY_B), "wb") as f:
            f.write(b"torn")
        (tmp_path / "token").write_text(self.TOKEN + "\n")
        extra = ["--metrics-token-file", str(tmp_path / "token")]
        if request.param:
            extra += ["--feature-gates", "ClusterCompileCache=true"]
        exp = Exporter(tmp_path, *extra)
        yield exp, cc, request.param
        assert exp.stop() == 0

    def test_route(self, exporter):
        exp, cc, gate_on = exporter
        url = exp.url + "/cache/entry?key="
        if not gate_on:
            # no route at all, with the token or without
            assert _get_raw(url + KEY_A, self.TOKEN)[0] == 404
            assert _get_raw(url + KEY_A)[0] == 404
            assert os.path.exists(cc.entry_path(KEY_B))
            return
        assert _get_raw(url + KEY_A)[0] == 401
        assert _get_raw(url + KEY_A, "wrong")[0] == 401
        status, raw = _get_raw(url + KEY_A, self.TOKEN)
        assert status == 200 and unwrap(raw) == b"served-exe"
        assert jcache.CompileCache._verify(KEY_A, raw) == b"served-exe"
        assert _get_raw(url + "c" * 64, self.TOKEN)[0] == 404
        for bad in ("..%2Fetc", KEY_A.upper(), KEY_A[:63], ""):
            assert _get_raw(url + bad, self.TOKEN)[0] == 400, bad
        # a corrupt entry is quarantined where it is served, never sent
        assert _get_raw(url + KEY_B, self.TOKEN)[0] == 404
        assert not os.path.exists(cc.entry_path(KEY_B))
        assert len(os.listdir(cc.quarantine_dir)) == 1

    def test_fetcher_downloads_through_the_route(self, exporter, tmp_path):
        """A cold node's fetcher with the peer token, against the
        exporter: the entry lands; without the token it compiles."""
        exp, _, gate_on = exporter
        endpoint = exp.url.removeprefix("http://")
        outcomes = []
        for token in (self.TOKEN, "wrong"):
            root = str(tmp_path / f"cold-{token}")
            os.makedirs(root)
            write_peers(root, KEY_A, endpoint)
            cc = tfetch.ClusterCompileCache(root, token=token)
            outcomes.append(cc.get_or_compile(KEY_A, lambda: b"local"))
        if gate_on:
            assert outcomes == [(b"served-exe", "fetch"), (b"local", "miss")]
        else:
            assert outcomes == [(b"local", "miss"), (b"local", "miss")]


# ---------------------------------------------------------------------------
# the node's counters
# ---------------------------------------------------------------------------

class TestMetrics:
    def test_fetch_counters_in_node_render(self, tmp_path):
        root = str(tmp_path / "warm" / "cc")
        tcache.CompileCache(root).put(KEY_A, b"exe")
        endpoint, _c, srv = serve_root(tfetch.read_entry_for_serving, root)
        try:
            cold = str(tmp_path / "cold" / "cc")
            os.makedirs(cold)
            write_peers(cold, KEY_A, endpoint)
            cc = tfetch.ClusterCompileCache(cold)
            assert cc.get_or_compile(KEY_A, lambda: b"x")[1] == "fetch"
            write_peers(cold, KEY_B, "127.0.0.1:1")
            cc.fetch_timeout_s = 0.5
            assert cc.get_or_compile(KEY_B, lambda: b"y")[1] == "miss"
            text = tcache.render_node_metrics(cold, "node-1")
            assert 'vtpu_compile_cache_peer_fetches_total' \
                '{node="node-1"} 1' in text
            assert 'vtpu_compile_cache_peer_fetch_failures_total' \
                '{node="node-1"} 1' in text
            # a fetch counts one hit, a failed rung then a compile a miss
            assert 'vtpu_compile_cache_hits_total{node="node-1"} 1' in text
            assert 'vtpu_compile_cache_misses_total{node="node-1"} 1' in text
            assert text == jcache.render_node_metrics(cold, "node-1")
        finally:
            srv.shutdown()


# ---------------------------------------------------------------------------
# the fleet bench's plumbing (its waves run on the card)
# ---------------------------------------------------------------------------

class TestFleetBench:
    def test_worker_env_arms_the_tier_as_allocate_would(self, tmp_path,
                                                        monkeypatch):
        from vtpu_manager_torch import bench_clustercache as bcc
        monkeypatch.setenv("VTPU_POD_UID", "stale")
        monkeypatch.setenv("LD_PRELOAD", "/x.so")
        node = bcc.node_dirs(tmp_path, "node-0")
        assert os.path.isdir(node.cache_root)
        on = bcc.worker_env(node, tmp_path / "w", True, "tok")
        off = bcc.worker_env(node, tmp_path / "w", False, "tok")
        assert (on[consts.ENV_COMPILE_CACHE], on[consts.ENV_CLUSTER_CACHE],
                on[consts.ENV_COMPILE_CACHE_DIR],
                on[consts.ENV_CACHE_PEER_TOKEN],
                on[consts.ENV_PROGRAM_FINGERPRINT]) == \
            ("true", "true", node.cache_root, "tok", bcc.FINGERPRINT)
        assert consts.ENV_CLUSTER_CACHE not in off
        # nothing of the calling process's tenant reaches the worker
        assert "VTPU_POD_UID" not in on and "LD_PRELOAD" not in on

    def test_summarize_counts_compiles_fetches_and_attempts(self):
        from vtpu_manager_torch import bench_clustercache as bcc
        rows = [{"outcome": o, "ttfs_s": t, "fxgraph_cache_miss": m,
                 "stats": {"peer_fetches": f, "peer_fetch_failures": x}}
                for o, t, m, f, x in (("fetch", 3.0, 0, 1, 0),
                                      ("wait", 4.0, 0, 0, 0),
                                      ("miss", 9.0, 2, 0, 1))]
        s = bcc.summarize("w", rows)
        assert (s["compiles"], s["fetches"], s["fetch_attempts"],
                s["ttfs_p50_s"], s["ttfs_max_s"]) == (1, 1, 2, 4.0, 9.0)

    def test_compile_cache_table_formats_every_scenario(self):
        """`python -m vtpu_manager_torch.bench_compilecache` prints one row
        per scenario from `summarize`'s numbers, node B's `peer` last."""
        from vtpu_manager_torch import bench_compilecache as bcc
        outcome = {"off": "miss", "cold": "miss", "warm": "hit",
                   "env": "hit", bcc.PEER: "fetch"}
        results = {name: bcc.summarize(name, [
            {"outcome": outcome[name], "ttfs_s": 1.5 + i,
             "fxgraph_cache_miss": int(name in ("off", "cold"))}
            for i in range(bcc.REPLICAS)]) for name in outcome}
        lines = bcc.table(results).splitlines()
        assert [ln.split()[0] for ln in lines[1:]] == [*bcc.SCENARIOS,
                                                       bcc.PEER]
        assert lines[-1].split()[1:4] == ["0", str(bcc.REPLICAS), "0"]
        assert lines[-1].split()[4] == f"{2.5:.3f}s"
