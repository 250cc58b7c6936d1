"""The port's CUDA kernel on the card, against its plain version.

Marked `gpu`: each test skips without an NVIDIA card (the kernel has no
CPU mode). This file imports no JAX, so it also runs where only the
port's dependencies are installed:

    python -m pytest tests/test_torch_gpu.py -m gpu

Tolerance 1e-4 absolute on the normalised output and on m: the kernel
sums in another order than the plain version's matrix products, with TF32
off, and takes its products as split TF32 (three tensor-core products
each, about fp32 accuracy; tests/test_torch_tf32_split.py has the
argument).
"""

import os

import pytest
import torch

from vtpu_manager_torch.util.torchplatform import exact_fp32
from vtpu_manager_torch.workloads import block_attention as ba
from vtpu_manager_torch.workloads import ring_attention as ra

TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernel has no CPU mode")
    exact_fp32()
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, b, h, sq, sk, d, dtype=torch.float32):
    q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
    return q, k, v


def _causal(sq, sk):
    rows = torch.arange(sq, device="cuda")[:, None]
    cols = torch.arange(sk, device="cuda")[None, :]
    return torch.where(rows >= cols, 0.0, float("-inf"))


def _assert_matches_plain(q, k, v, bias):
    before = ba.LAUNCHES["attn_block"]
    o, m, l = ba.attention_block(q, k, v, bias)
    ro, rm, rl = ra.block_partials(q.float(), k.float(), v.float(), bias)
    torch.cuda.synchronize()
    assert ba.LAUNCHES["attn_block"] == before + 1
    out = ba.combine_blocks([(o, m, l)])
    ref = ba.combine_blocks([(ro, rm, rl)])
    assert (out - ref).abs().max().item() <= TOL
    assert torch.equal(torch.isneginf(m), torch.isneginf(rm))
    assert torch.allclose(m.nan_to_num(neginf=0.0), rm.nan_to_num(neginf=0.0),
                          atol=TOL, rtol=0)
    assert torch.allclose(l, rl, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,sk,d,dtype", [
    (2, 4, 100, 70, 64, torch.float32),     # ragged tiles both ways
    (1, 2, 33, 129, 128, torch.float32),
    (2, 2, 64, 64, 8, torch.bfloat16),
    (1, 1, 5, 3, 1, torch.float32),
    (2, 4, 100, 70, 72, torch.bfloat16),
    (1, 2, 40, 130, 33, torch.bfloat16),    # odd d: plain bf16 copies
])
def test_kernel_matches_plain(card, b, h, sq, sk, d, dtype):
    q, k, v = _inputs(card, b, h, sq, sk, d, dtype)
    _assert_matches_plain(q, k, v, _causal(sq, sk))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 8, 72, 128])
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_kernel_head_dims_and_large_scores(card, d, q_scale):
    # ragged 100 x 70; q x 8 gives large, peaked scores, where one TF32
    # pass would miss the tolerance a hundred times over
    q, k, v = _inputs(card, 2, 4, 100, 70, d)
    _assert_matches_plain(q * q_scale, k, v, _causal(100, 70))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_rows_off_16_byte_alignment(card, dtype):
    # one element into a buffer: the kernel copies narrower, not elsewhere
    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device="cuda")
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    q, k, v = map(shifted, _inputs(card, 1, 2, 70, 130, 64, dtype))
    assert q.data_ptr() % 16 != 0
    _assert_matches_plain(q, k, v, _causal(70, 130))


@pytest.mark.gpu
def test_one_call_is_one_kernel_launch(card):
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _inputs(card, 2, 4, 100, 70, 64)
    bias = _causal(100, 70)
    ba.attention_block(q, k, v, bias)               # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ba.attention_block(q, k, v, bias)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    assert [(e.count, "AttnBlockKernel" in e.key) for e in kernels] == \
        [(1, True)], [e.key for e in kernels]


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _inputs(card, 1, 1, 8, 8, 8)
    bias = torch.zeros((8, 8), device="cuda")
    with pytest.raises(ValueError):
        ba.attention_block(q.transpose(2, 3), k, v, bias)    # a strided view
    with pytest.raises(ValueError):
        ba.attention_block(q.half(), k.half(), v.half(), bias)
    wide = _inputs(card, 1, 1, 8, 8, 256)
    with pytest.raises(ValueError):
        ba.attention_block(*wide, bias)


@pytest.mark.gpu
def test_step_device_share_is_a_share(card):
    from vtpu_manager_torch.bench_steps import step_device_share
    out = step_device_share(dim=512, warmup=2, steps=5)
    assert 0 < out["device_ms_per_step"] <= out["ms_per_step"] * 1.05
    assert 0 < out["busy_share"] <= 1.05


@pytest.mark.gpu
def test_nvml_backend_finds_torchs_card(card):
    from vtpu_manager_torch.tpu import discovery
    nvml = discovery.Nvml.load()
    assert nvml is not None, "a machine with a card has NVML"
    found = discovery.NvmlBackend(nvml).discover()
    props = torch.cuda.get_device_properties(0)
    chip = next(c for c in found.chips if c.uuid == f"GPU-{props.uuid}")
    assert nvml.name(nvml.handle(chip.index)) == torch.cuda.get_device_name(0)
    assert abs(chip.memory - props.total_memory) <= 2**20
    assert chip.core_count in (0, props.multi_processor_count)
    assert 0 <= nvml.utilization(nvml.handle(chip.index)) <= 100


@pytest.mark.gpu
def test_two_processes_of_one_tenant_share_a_cap(card, tmp_path):
    """Two processes of one tenant under a 1 GiB cap from the config
    file: the first holds 768 MiB, the second is refused 512 MiB and
    granted 128 MiB."""
    from pathlib import Path

    from vtpu_manager_torch import bench_quota as bq
    from vtpu_manager_torch import build
    world = bq.World(str(tmp_path / "node"))
    shim = str(build.build_shim())
    env = world.env(shim, "pod-sib", cap=2**30)
    release = str(tmp_path / "release")
    first = bq.Tenant("first", bq.hold_args("0.75", world.go_file("first"),
                                            release), env, str(tmp_path))
    second = bq.Tenant("second", bq.hold_args(
        "0.5,0.125", world.go_file("second"), release), env, str(tmp_path))
    try:
        first.line("READY")
        second.line("READY")
        Path(world.go_file("first")).touch()
        assert first.line("HOLD ")["verdicts"] == ["granted"]
        Path(world.go_file("second")).touch()
        out = second.line("HOLD ")
        assert out["verdicts"] == ["refused", "granted"]
        assert out["vtpu_oom_rejected_total"] >= 1
        assert out["source"] == "config-file"
        Path(release).touch()
    finally:
        first.stop()
        second.stop()


# --- the device plugin on the card ------------------------------------------


def _nvml_node(tmp_path):
    """The port's device manager over NVML, and a plugin on a private node."""
    from vtpu_manager_torch.bench_allocate import NODE
    from vtpu_manager_torch.client.fake import FakeKubeClient
    from vtpu_manager_torch.config.node_config import NodeConfig
    from vtpu_manager_torch.deviceplugin.vnum import VnumPlugin
    from vtpu_manager_torch.manager.device_manager import DeviceManager
    from vtpu_manager_torch.tpu.discovery import NvmlBackend
    client = FakeKubeClient()
    client.add_node({"metadata": {"name": NODE}})
    mgr = DeviceManager(NODE, client, NodeConfig(device_split_count=4),
                        backends=[NvmlBackend()])
    mgr.init_devices()
    plugin = VnumPlugin(mgr, client, NODE,
                        base_dir=str(tmp_path / "mgr"),
                        shim_host_dir=str(tmp_path / "driver"),
                        lock_dir=str(tmp_path / "locks"),
                        vmem_dir=str(tmp_path / "vmem"),
                        watcher_dir=str(tmp_path / "watcher"))
    uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
    chip = next(c for c in mgr.chips if c.uuid == uuid)
    return mgr, plugin, client, chip


def _allocate(plugin, client, chip, name, cores, memory):
    from vtpu_manager_torch import bench_allocate
    from vtpu_manager_torch.deviceplugin.api import messages as api
    from vtpu_manager_torch.deviceplugin.vnum import device_id
    client.add_pod(bench_allocate.committed_pod(name, chip, cores, memory))
    return plugin.allocate(api.AllocateRequest([api.ContainerAllocateRequest(
        [device_id(chip.uuid, 0)])])).container_responses[0]


@pytest.mark.gpu
def test_nvml_device_manager_sees_torch_card(card, tmp_path):
    import os
    mgr, _, _, chip = _nvml_node(tmp_path)
    props = torch.cuda.get_device_properties(0)
    assert abs(chip.memory - props.total_memory) <= 2**20
    assert chip.core_count == props.multi_processor_count
    assert chip.split_count == 4
    assert os.path.exists(mgr.device_node(chip.index))


@pytest.mark.gpu
def test_allocate_on_card_writes_usable_memory(card, tmp_path):
    import os

    from vtpu_manager_torch.config import vtpu_config as vc
    from vtpu_manager_torch.util import consts
    _, plugin, client, chip = _nvml_node(tmp_path)
    resp = _allocate(plugin, client, chip, "pod-1", 25, 4 * 2**30)
    assert client.get_pod("default", "pod-1")["metadata"]["annotations"][
        consts.allocation_status_annotation()] == consts.ALLOC_STATUS_SUCCEED
    host = next(m.host_path for m in resp.mounts
                if m.container_path == f"{consts.MANAGER_BASE_DIR}/config")
    dev = vc.read_config(os.path.join(host, "vtpu.config")).devices[0]
    assert dev.real_memory == chip.memory
    assert abs(dev.real_memory - torch.cuda.get_device_properties(
        0).total_memory) <= 2**20
    assert resp.envs[consts.ENV_NVIDIA_VISIBLE_DEVICES] == chip.uuid


@pytest.mark.gpu
def test_tenant_from_allocate_response_sees_its_cap(card, tmp_path):
    import json
    import subprocess
    import sys

    from vtpu_manager_torch import bench_allocate, build
    from vtpu_manager_torch.deviceplugin.vnum import install_interposer
    _, plugin, client, chip = _nvml_node(tmp_path)
    install_interposer(str(build.build_shim()), plugin.shim_host_dir)
    resp = _allocate(plugin, client, chip, "pod-1", 0, 3 * 2**30)
    res = subprocess.run(
        [sys.executable, "-m", "vtpu_manager_torch.bench_quota",
         "--hbm-worker"], env=bench_allocate.container_env(resp),
        cwd=str(build.REPO), capture_output=True, text=True, timeout=300)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("HBM ")]
    assert lines, res.stderr[-2000:]
    out = json.loads(lines[0][4:])
    assert out["total"] == 3 * 2**30 and out["source"] == "config-file"


@pytest.mark.gpu
def test_dra_prepare_over_nvml_names_the_cards_device_node(card, tmp_path):
    import json
    import os

    from vtpu_manager_torch import bench_dra
    from vtpu_manager_torch.kubeletplugin import cdi
    from vtpu_manager_torch.kubeletplugin.device_state import DeviceState
    from vtpu_manager_torch.tpu import discovery
    mgr, _, _, chip = _nvml_node(tmp_path)
    nvml = discovery.Nvml.load()
    minor = nvml.minor(nvml.handle(chip.index))
    state = DeviceState("n1", mgr.chips, base_dir=str(tmp_path / "dra"),
                        cdi_dir=str(tmp_path / "cdi"), minors=mgr.minors,
                        lock_dir=str(tmp_path / "locks"),
                        vmem_dir=str(tmp_path / "vmem"),
                        watcher_dir=str(tmp_path / "watcher"))
    claim = bench_dra.allocated_claim("c1", chip.index, {"gpu": [1]}, 25,
                                      1024)
    assert state.prepare_claim(claim) == [cdi.cdi_device_name("uid-c1")]
    with open(cdi.spec_path("uid-c1", str(tmp_path / "cdi"))) as f:
        (device,) = json.load(f)["devices"]
    nodes = [n["path"] for n in device["containerEdits"]["deviceNodes"]]
    assert nodes[0] == f"/dev/nvidia{minor}" and os.path.exists(nodes[0])
    assert nodes[1:] == ["/dev/nvidiactl", "/dev/nvidia-uvm"]


# --- every launch path and allocation entry under the interposer -------------


@pytest.mark.gpu
def test_graph_replays_are_metered(card):
    """The quota step and one attention launch replayed from a CUDA graph
    at q50 and q25, each paired with the eager step at quota 100: shares
    within 15 points and in order, every replay counted, the capture
    charged nothing, one cooperative launch counted."""
    from vtpu_manager_torch import bench_quota as bq
    from vtpu_manager_torch import build
    sweep = bq.graph_sweep(str(build.build_shim()))
    verdicts = bq.graph_sweep_ok(sweep, 15.0)
    assert verdicts["ok"], (verdicts, sweep)


@pytest.mark.gpu
def test_another_threads_launches_leave_a_global_capture_valid(card):
    """S1: one thread captures the quota step and an attention launch in
    torch's default global mode while another launches a metered kernel
    through the driver API on its own stream; the capture ends valid and
    replays the eager outputs, and the interposer metered and sampled the
    other thread's launches."""
    from vtpu_manager_torch import bench_quota as bq
    from vtpu_manager_torch import build
    rec = bq.run_cross_capture(str(build.build_shim()))
    assert rec is not None
    assert rec["capture_error"] is None and "b_error" not in rec, rec
    assert rec["b_failed_launches"] == 0, rec
    assert rec["max_abs_err"] <= 1e-4, rec
    assert rec["b_vtpu_launches_total"] > 0, rec
    assert rec["b_vtpu_sampled_launches_total"] > 0, rec


@pytest.mark.gpu
def test_allocation_entries_are_capped(card):
    """Under a 64 MiB cap, 256 MiB through cuMemAllocManaged,
    cuMemAllocPitch_v2 and cuMemAllocFromPoolAsync is refused with
    CUDA_ERROR_OUT_OF_MEMORY; 32 MiB is granted, freed, granted again."""
    from vtpu_manager_torch import bench_quota as bq
    from vtpu_manager_torch import build
    rec = bq.run_entry_check(str(build.build_shim()))
    assert bq.entry_check_ok(rec), rec


# --- the node exporter on the card -----------------------------------------


@pytest.mark.gpu
def test_collector_reads_back_a_tenants_held_memory(card, tmp_path):
    """A tenant under the interposer holds 64 MiB; the exporter's collector
    reports the tenant's ledger bytes, at least the 64 MiB it holds."""
    import os
    import shutil
    from pathlib import Path

    from vtpu_manager_torch import bench_quota as bq
    from vtpu_manager_torch import build
    from vtpu_manager_torch.config.vmem import VmemLedger, fnv64
    from vtpu_manager_torch.metrics.collector import NodeCollector
    from vtpu_manager_torch.tpu.discovery import NvmlBackend
    world = bq.World(str(tmp_path / "node"))
    env = world.env(str(build.build_shim()), "pod-mon", cap=2**30)
    base = tmp_path / "mgr" / "pod-mon_main" / "config"
    base.mkdir(parents=True)
    shutil.copy(env["VTPU_CONFIG_PATH"], base / "vtpu.config")
    release = str(tmp_path / "release")
    tenant = bq.Tenant("hold", bq.hold_args("0.0625", world.go_file("hold"),
                                            release), env, str(tmp_path))
    try:
        tenant.line("READY")
        Path(world.go_file("hold")).touch()
        assert tenant.line("HOLD ")["verdicts"] == ["granted"]
        chips = NvmlBackend().discover().chips
        text = NodeCollector("n1", chips, base_dir=str(tmp_path / "mgr"),
                             tc_path=world.tc_path,
                             vmem_path=world.vmem_path).render()
        led = VmemLedger(world.vmem_path)
        held = sum(e.bytes for e in led.entries()
                   if e.owner_token == fnv64("pod-mon/main"))
        led.close()
        Path(release).touch()
    finally:
        tenant.stop()
    rows = [ln for ln in text.splitlines() if ln.startswith(
        'vtpu_container_memory_used_bytes{node="n1",pod_uid="pod-mon"')]
    assert len(rows) == 1, text
    used = float(rows[0].rsplit(" ", 1)[1])
    assert used == held >= 64 * 2**20
    assert os.path.exists(world.vmem_path)


@pytest.mark.gpu
def test_custom_op_in_a_compiled_step_launches_the_kernel(card, tmp_path,
                                                          monkeypatch):
    """`torch.compile` of the compiled step (Inductor, in empty cache
    directories) reaches the kernel through `vtpu::attn_block`: one launch
    per step, outputs equal to the eager step's."""
    from vtpu_manager_torch.workloads import compiled_step as cs
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "inductor"))
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "triton"))
    inputs = cs.make_inputs(dim=1024, device="cuda")
    torch._dynamo.reset()
    before = ba.LAUNCHES["attn_block"]
    (y, a), outcome, _ = cs.first_step(inputs)
    torch.cuda.synchronize()
    assert outcome == "uncached"
    assert ba.LAUNCHES["attn_block"] == before + 1
    ey, ea = cs.step(*inputs)
    assert (a - ea).abs().max().item() <= TOL
    # y is bf16 below 1e-3, where a bf16 step is at most 7.6e-6: Inductor's
    # fused tail may round differently from eager's kernels by a few steps
    assert (y.float() - ey.float()).abs().max().item() <= 3e-5
    torch._dynamo.reset()


@pytest.mark.gpu
def test_traced_tenant_spools_its_stages(card, tmp_path, monkeypatch):
    """A tenant whose Allocate env carries a sampled trace id: install,
    first execute and the compiled step through the node store (a miss)
    spool `shim.install`, `shim.first_execute`, `shim.compile` and its
    outcome, in that order, and the step launches the kernel once."""
    from vtpu_manager_torch import trace
    from vtpu_manager_torch.runtime import client as rt
    from vtpu_manager_torch.trace import assemble
    from vtpu_manager_torch.util import consts
    from vtpu_manager_torch.workloads import compiled_step as cs
    shim = tmp_path / "libvtpu-cuda-control.so"
    shim.write_bytes(b"")
    for var, value in ((consts.ENV_TRACE_ID, "tid-gpu"),
                       (consts.ENV_TRACE_SAMPLED, "true"),
                       (consts.ENV_POD_UID, "uid-gpu"),
                       (consts.ENV_TRACE_DIR, str(tmp_path / "spool")),
                       (consts.ENV_COMPILE_CACHE, "true"),
                       (consts.ENV_COMPILE_CACHE_DIR, str(tmp_path / "cc")),
                       (consts.ENV_INDUCTOR_CACHE_DIR,
                        str(tmp_path / "inductor")),
                       (consts.ENV_TRITON_CACHE_DIR,
                        str(tmp_path / "triton"))):
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(rt, "_first_execute_marked", False)
    trace.reset()
    rt._reset_compile_cache()
    torch._dynamo.reset()
    try:
        assert rt.install(shim_path=str(shim)) is not None
        inputs = cs.make_inputs(dim=1024, device="cuda")
        cache = rt.compile_cache()
        rt.mark_first_execute()
        before = ba.LAUNCHES["attn_block"]
        _, outcome, _ = cs.first_step(inputs, cache, cs.entry_key(inputs))
        torch.cuda.synchronize()
        launches = ba.LAUNCHES["attn_block"] - before
        trace.flush()
        spans, drops = assemble.read_spools(str(tmp_path / "spool"))
    finally:
        trace.reset()
        rt._reset_compile_cache()
        torch._dynamo.reset()
    assert (outcome, launches, sum(drops.values())) == ("miss", 1, 0)
    ordered = sorted(spans, key=lambda s: s.start_s)
    assert [s.stage for s in ordered] == [
        "shim.install", "shim.first_execute", "shim.compile",
        "shim.compile_outcome"]
    assert {(s.trace_id, s.pod_uid, s.service) for s in spans} == {
        ("tid-gpu", "uid-gpu", "tenant")}
    assert ordered[3].attrs["outcome"] == "miss"


@pytest.mark.gpu
def test_cold_node_fetches_the_compiled_step_from_a_warm_peer(card, tmp_path,
                                                               monkeypatch):
    """The cluster tier on the card: node A's store compiles the compiled
    step (a miss, and the fingerprint's marker); node B's store, empty,
    with a `peers.json` naming A's serving read over HTTP, fetches the
    entry (outcome `fetch`) and B's first step loads it with no Inductor
    compile, launches the kernel once and gives A's outputs."""
    import json
    import threading
    import time
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    from vtpu_manager_torch.clustercache import (ClusterCompileCache,
                                                 advertise,
                                                 read_entry_for_serving)
    from vtpu_manager_torch.util import consts
    from vtpu_manager_torch.workloads import compiled_step as cs

    roots = {n: str(tmp_path / n / "cc") for n in ("a", "b")}

    class Serve(BaseHTTPRequestHandler):
        def do_GET(self):
            key = parse_qs(urlparse(self.path).query).get("key", [""])[0]
            raw = read_entry_for_serving(roots["a"], key)
            if raw is None:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Serve)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    monkeypatch.setenv(consts.ENV_PROGRAM_FINGERPRINT, "compiled-step-gpu")
    inputs = cs.make_inputs(dim=1024, device="cuda")
    key = cs.entry_key(inputs)
    outs, outcomes, launches, misses = {}, {}, {}, {}
    try:
        for node in ("a", "b"):
            for var in (consts.ENV_INDUCTOR_CACHE_DIR,
                        consts.ENV_TRITON_CACHE_DIR):
                monkeypatch.setenv(var, str(tmp_path / node / var.lower()))
            if node == "b":
                os.makedirs(roots["b"], exist_ok=True)
                with open(os.path.join(roots["b"], consts.CACHE_PEERS_NAME),
                          "w") as f:
                    json.dump({"ts": time.time(), "peers": [{
                        "node": "a", "endpoint":
                            f"127.0.0.1:{srv.server_port}",
                        "keys": {key: "compiled-step-gpu"}}]}, f)
            torch._dynamo.reset()
            cache = ClusterCompileCache(roots[node])
            before = ba.LAUNCHES["attn_block"]
            miss0 = cs.compile_counters()["fxgraph_cache_miss"]
            outs[node], outcomes[node], _ = cs.first_step(inputs, cache, key)
            torch.cuda.synchronize()
            launches[node] = ba.LAUNCHES["attn_block"] - before
            misses[node] = cs.compile_counters()["fxgraph_cache_miss"] - miss0
            if node == "b":
                assert cache.stats.peer_fetches == 1
    finally:
        srv.shutdown()
        torch._dynamo.reset()
    assert outcomes == {"a": "miss", "b": "fetch"}
    assert launches == {"a": 1, "b": 1}
    assert misses["a"] >= 1 and misses["b"] == 0
    assert advertise.scan_warm_pairs(roots["a"]) == [("compiled-step-gpu",
                                                      key)]
    for x, y in zip(outs["a"], outs["b"]):
        assert (x.float() - y.float()).abs().max().item() <= TOL


@pytest.mark.gpu
def test_two_gloo_ranks_on_the_card_run_the_kernel_ring(card):
    # NCCL refuses two ranks on one device; gloo shares the card, staging
    # the K/V rotation through pinned host buffers. The job is the card
    # phase's own (chip_smoke.py, importable from the repo's root), at a
    # smaller ring.
    from vtpu_manager_torch.workloads import ranks
    results = ranks.launch("chip_smoke:shared_card_rank", 2, device="cuda",
                           backend="gloo", args={"shape": [2, 4, 256, 64],
                                                 "tol": TOL}, timeout=300)
    for r in results:
        assert r["ring_diff_plain"] <= TOL, results
        assert r["ring_err_ref"] <= TOL, results
        assert r["attn_block_launches"] == 2, results    # one per ring step


# --- communication accounting on the card -------------------------------------

_COPIES = """
import ctypes, json, torch
n = 1 << 20                       # 4 MiB of fp32 per copy
x = torch.arange(n, dtype=torch.float32)
y = x.to("cuda")                  # host to card, pageable
z = y.cpu()                       # card to host, pageable
pinned = torch.empty(n, dtype=torch.float32, pin_memory=True)
pinned.copy_(y)                   # card to host, pinned
w = pinned.to("cuda", non_blocking=True)   # host to card, asynchronous
d = torch.empty_like(y).copy_(y)  # card to card: not counted
torch.cuda.synchronize()
lib = ctypes.CDLL(None)
out = {}
for name in ("vtpu_comm_time_ns_total", "vtpu_comm_bytes_total",
             "vtpu_collectives_total"):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_uint64
    out[name] = fn()
buf = ctypes.create_string_buffer(1024)
lib.vtpu_comm_entries(buf, 1024)
out["entries"] = buf.value.decode()
# read after the totals: the comparisons copy to the host themselves
assert torch.equal(z, x) and torch.equal(w, y) and torch.equal(d, y)
print("COMM " + json.dumps(out))
"""


@pytest.mark.gpu
@pytest.mark.parametrize("armed", [True, False])
def test_copies_are_counted_by_direction(card, tmp_path, armed):
    """A tenant's four host-card copies of 4 MiB (pageable and pinned, to
    and from the card; the last one asynchronous) and one card-to-card
    copy under the interposer: armed, exactly 16 MiB counted with a span
    and no collective; unarmed, nothing."""
    import json
    import subprocess
    import sys

    from vtpu_manager_torch import bench_quota as bq
    from vtpu_manager_torch import build
    world = bq.World(str(tmp_path / "node"))
    env = world.env(str(build.build_shim()), "pod-comm")
    if armed:
        env["VTPU_COMM_TELEMETRY"] = "true"
    res = subprocess.run([sys.executable, "-c", _COPIES], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(next(line for line in res.stdout.splitlines()
                          if line.startswith("COMM "))[5:])
    if armed:
        assert out["vtpu_comm_bytes_total"] == 4 * 4 * 2**20, out
        assert out["vtpu_comm_time_ns_total"] > 0, out
        assert out["vtpu_collectives_total"] == 0, out
        assert out["entries"], out
    else:
        assert (out["vtpu_comm_time_ns_total"], out["vtpu_comm_bytes_total"],
                out["vtpu_collectives_total"], out["entries"]) == \
            (0, 0, 0, ""), out


@pytest.mark.gpu
def test_a_lease_adopted_under_graph_replays_paces_them(card, tmp_path):
    """A hard-25 tenant replaying the quota step and one attn_block launch
    from a CUDA graph, its config rewritten as the quota market writes it
    (+75, +25, then 0): the replays follow each lease within the phase's
    band (bench_quota_lease.judge_lease, the effective-100 stage's charge
    per step the yardstick), and every rewrite is adopted."""
    from vtpu_manager_torch import bench_quota as bq
    from vtpu_manager_torch import bench_quota_lease as bl
    from vtpu_manager_torch import build
    world = bq.World(str(tmp_path / "node"))
    env = world.env(str(build.build_shim()), "pod-graph", hard_core=25,
                    uuid="GPU-graph", real_memory=0)
    go, stop = world.go_file("graph"), str(tmp_path / "stop")
    tenant = bq.Tenant("graph", [
        "-m", "vtpu_manager_torch.bench_quota_lease", "--tenant", "lease",
        "--graph", "--go-file", go, "--stop-file", stop], env,
        str(tmp_path))
    try:
        tenant.line("READY", 240)
        marks = bl.drive(env["VTPU_CONFIG_PATH"], go, stop, freeze=False,
                         base_s=0.5, stage_s=1.5)
        run = tenant.line("STEPS ", 240)
        assert tenant.proc.wait(timeout=60) == 0
    finally:
        tenant.stop()
    rec = bl.judge_lease(run, marks)
    assert run["graph"] and run["vtpu_graph_launches_total"] >= rec["steps"]
    assert rec["ok"], (rec["stages"], rec["reloads"], rec["epoch"],
                       rec["counters"])


# --- HBMOvercommit's overflow tier on the card --------------------------------


@pytest.fixture(scope="module")
def overflow_probe(tmp_path_factory):
    """One tenant whose config gives the card 1 GiB of physical memory, 2
    GiB of virtual capacity and a 512 MiB spill budget, the pool armed:
    1 GiB on the card, then 256 MiB past it, then 512 MiB past the
    budget, then the free (`bench_overcommit.run_probe`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from vtpu_manager_torch import bench_overcommit, build
    return bench_overcommit.run_probe(
        str(build.build_shim()), str(tmp_path_factory.mktemp("overflow")))


@pytest.mark.gpu
def test_an_overflow_grant_is_host_memory(card, overflow_probe):
    rec = overflow_probe
    # the location of the memory mapped there, as the driver reads it back
    # (cuMemGetAllocationPropertiesFromHandle)
    assert rec["where"] == "host", rec
    assert rec["spills"] == 1 and rec["spilled"] == 256 * 2**20, rec
    assert rec["pattern_ok"], rec


@pytest.mark.gpu
def test_an_overflow_past_the_budget_is_refused(card, overflow_probe):
    rec = overflow_probe
    assert rec["refused"], rec
    # every driver call of torch's attempts was the tier's refusal
    assert rec["rejected"] == rec["oom_rejected"] >= 1, rec


@pytest.mark.gpu
def test_the_free_returns_the_overflows_credit(card, overflow_probe):
    assert overflow_probe["spilled_after_free"] == 0, overflow_probe
