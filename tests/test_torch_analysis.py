"""repro_torch.analysis, case for case with tests/test_analysis.py where a
rule carries over: each rule flags a planted snippet in its torch form and
passes the dispatch-point code it must allow, the allowlist suppresses
exactly the finding it pins, seeded violations in a copy of the port's
package are caught, the CLI's exit codes, and the device audit's host-side
checks (``donation``, ``compile-keys``) clean on a CPU engine and catching
their planted faults. The reference's ``jit-hygiene`` and
``recompile-hazard`` are ``jax.jit`` rules and have no counterpart; the
audit's ``compile-keys`` takes the place of the latter's seeded case. The
``callback`` and ``const`` checks need the card
(tests/test_torch_cuda.py)."""
import dataclasses
import shutil
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import ALL_RULES, AllowEntry, load_allowlist, run_lint
from repro_torch.analysis.lint import _parse_toml_minimal

PACKAGE = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def lint_snippet(tmp_path, relpath, code, allowlist=()):
    p = tmp_path / relpath
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(code))
    return run_lint(tmp_path, ALL_RULES, allowlist)


def rules_of(report):
    return [f.rule for f in report.findings]


def test_rules_are_the_ones_that_carry_over():
    assert [r.id for r in ALL_RULES] == ["sync-point", "emit-discipline",
                                         "residency-discipline", "obs-discipline"]


# --------------------------------------------------------------------------
# sync-point
# --------------------------------------------------------------------------


def test_sync_point_flags_readback_in_decode_step(tmp_path):
    rep = lint_snippet(tmp_path, "serving/batching.py", """
        import numpy as np
        class BatchedServingEngine:
            def _decode_step(self, batch):
                ids_np = self.ids.cpu().numpy()
                return ids_np
    """)
    # the .numpy() of a .cpu() reads host memory: one finding, the .cpu()
    assert rules_of(rep) == ["sync-point"]
    f = rep.findings[0]
    assert f.path == "serving/batching.py" and f.line == 5
    assert f.scope == "BatchedServingEngine._decode_step"
    assert f.call == "self.ids.cpu"


@pytest.mark.parametrize("call", [
    "x.item()", "x.cpu()", "x.tolist()", "x.numpy()", "float(x)", "int(x)",
    "np.asarray(x)", "torch.cuda.synchronize()", "self._ready[0].synchronize()",
    "stream.synchronize()",
])
def test_sync_point_flags_every_sync_form(tmp_path, call):
    rep = lint_snippet(tmp_path, "serving/engine.py", f"""
        import numpy as np
        import torch
        class MoEServingEngine:
            def decode(self, x, stream):
                return {call}
    """)
    assert rules_of(rep) == ["sync-point"]


def test_sync_point_ignores_cold_scopes(tmp_path):
    rep = lint_snippet(tmp_path, "serving/batching.py", """
        import numpy as np
        class BatchedServingEngine:
            def snapshot(self, req):
                return self.thing.cpu()
        def helper(x):
            return x.item()
    """)
    assert rep.findings == []


def test_sync_point_ignores_host_values(tmp_path):
    rep = lint_snippet(tmp_path, "serving/batching.py", """
        import numpy as np
        class BatchedServingEngine:
            def _decode_step(self, batch, n: int, causal: bool):
                a = np.asarray([r.pos for r in batch], np.int32)
                b = np.asarray([1, 2, 3])
                c = float("nan")
                d = int(n) + int(causal) + int(n * 2 - 1) + int(len(batch))
                for i in range(4):
                    d += int(i)
                e = int(a.dtype == np.int32)
                f = self.x.float()   # a cast on the device, not a readback
                return a, b, c, d, e, f
    """)
    assert rep.findings == []


@pytest.mark.parametrize("call", [
    "torch.as_tensor(idx, dtype=torch.long, device=self.device)",
    "torch.as_tensor(self._slot_pos[idx], device=dev)",
    "torch.tensor(pos_np, device=self.device)",
    "torch.from_numpy(pos_np).to(dev)",
    "torch.from_numpy(pos_np).to(device=self.device)",
    "torch.from_numpy(pos_np).to('cuda')",
    "torch.from_numpy(pos_np).cuda()",
])
def test_sync_point_flags_pageable_upload(tmp_path, call):
    """An upload from pageable host memory waits for the stream: flagged in
    a hot scope, with the helper named in the message."""
    rep = lint_snippet(tmp_path, "serving/batching.py", f"""
        import torch
        class BatchedServingEngine:
            def _kv_rows(self, l: int, idx, pos_np, dev):
                return {call}
    """)
    assert rules_of(rep) == ["sync-point"]
    assert "models.layers.upload" in rep.findings[0].message


def test_sync_point_allows_pinned_non_blocking_upload(tmp_path):
    """The upload helper, a pinned ``non_blocking`` copy, a device-side
    cast and a host array's element are not syncs."""
    rep = lint_snippet(tmp_path, "serving/engine.py", """
        import numpy as np
        import torch
        from repro_torch.models.layers import upload
        class EngineCore:
            def _embed(self, tokens, idx: np.ndarray):
                tok = upload(tokens, self.device, torch.long)
                pin = torch.from_numpy(idx).pin_memory().to(self.device, non_blocking=True)
                lo = int(idx[0])
                return self.dev["embed"][tok].to(torch.float32), pin.to(tok.dtype), lo
    """)
    assert rep.findings == []


def test_sync_point_scans_kernels_everywhere(tmp_path):
    rep = lint_snippet(tmp_path, "kernels/custom.py", """
        def my_kernel(x):
            return x.item()
    """)
    assert rules_of(rep) == ["sync-point"]


# --------------------------------------------------------------------------
# emit-discipline
# --------------------------------------------------------------------------


def test_emit_flags_token_event_outside_sink(tmp_path):
    rep = lint_snippet(tmp_path, "serving/frontend.py", """
        from repro_torch.serving.api import TokenEvent
        class ServingFrontend:
            def poll(self, rid, tok):
                self.engine._emit(TokenEvent(rid=rid, token=tok, index=0,
                                             t=0.0))
    """)
    assert rules_of(rep) == ["emit-discipline"]
    assert rep.findings[0].call == "TokenEvent"


def test_emit_flags_raw_buffer_append(tmp_path):
    rep = lint_snippet(tmp_path, "serving/batching.py", """
        class BatchedServingEngine:
            def _retire(self, ev):
                self._events.append(ev)
    """)
    assert rules_of(rep) == ["emit-discipline"]


def test_emit_allows_the_sinks(tmp_path):
    rep = lint_snippet(tmp_path, "serving/engine.py", """
        from repro_torch.serving.api import TokenEvent
        class EngineCore:
            def _emit(self, ev):
                self._events.append(ev)
        class MoEServingEngine:
            def _emit_token(self, rid, token, index):
                self._emit(TokenEvent(rid=rid, token=token, index=index,
                                      t=0.0))
    """)
    assert rep.findings == []


# --------------------------------------------------------------------------
# residency-discipline
# --------------------------------------------------------------------------


def test_residency_flags_kv_write_outside_writers(tmp_path):
    rep = lint_snippet(tmp_path, "serving/batching.py", """
        class BatchedServingEngine:
            def evil_helper(self, l, ck):
                self._K[l][0] = ck
    """)
    assert rules_of(rep) == ["residency-discipline"]
    assert rep.findings[0].call == "_K"


def test_residency_flags_pool_write_outside_residency(tmp_path):
    rep = lint_snippet(tmp_path, "core/cache.py", """
        class SomethingElse:
            def poke(self, w):
                self._pools["w1"] = w
    """)
    assert rules_of(rep) == ["residency-discipline"]


def test_residency_allows_declared_writers(tmp_path):
    rep = lint_snippet(tmp_path, "serving/batching.py", """
        class BatchedServingEngine:
            def _decode_step(self, l, ck, jidx, slot):
                self._K[l][jidx, slot] = ck
            def restore(self, l, K, V):
                self._K[l], self._V[l] = K, V
            def _release_slot(self, req):
                self._slot_pos[req.slot, :] = -1
            def _seed_rows(self, l, slot, s):
                self._K[l][slot] = self._K[l][s]
    """)
    assert rep.findings == []
    rep2 = lint_snippet(tmp_path / "b", "core/cache.py", """
        class ExpertResidency:
            def _regrow(self, name, val):
                self._pools[name] = val
    """)
    assert rep2.findings == []


# --------------------------------------------------------------------------
# obs-discipline
# --------------------------------------------------------------------------


def test_obs_flags_migrated_metric_write(tmp_path):
    rep = lint_snippet(tmp_path, "serving/cluster.py", """
        class ReplicaPool:
            def migrate(self, rid, src, dst):
                self.n_handoffs += 1
                return rid
    """)
    assert rules_of(rep) == ["obs-discipline"]
    f = rep.findings[0]
    assert f.call == "n_handoffs"
    assert "read-only view" in f.message


def test_obs_flags_subscript_write_to_migrated_metric(tmp_path):
    rep = lint_snippet(tmp_path, "serving/cluster.py", """
        class QosAutopilot:
            def scan(self, now, reason):
                self.by_reason[reason] += 1
    """)
    assert rules_of(rep) == ["obs-discipline"]
    assert rep.findings[0].call == "by_reason"


def test_obs_flags_perf_field_write(tmp_path):
    rep = lint_snippet(tmp_path, "serving/batching.py", """
        class BatchedServingEngine:
            def _retire(self, r):
                self.perf.decode_layers = 0
    """)
    assert rules_of(rep) == ["obs-discipline"]
    f = rep.findings[0]
    assert f.call == "perf.decode_layers"
    assert "perf.inc" in f.message


def test_obs_flags_span_call_outside_declared_scope(tmp_path):
    rep = lint_snippet(tmp_path, "serving/batching.py", """
        class BatchedServingEngine:
            def _some_helper(self, r):
                self.obs.instant("request.peeked", "lifecycle", rid=r.rid)
    """)
    assert "obs-discipline" in rules_of(rep)
    f = next(f for f in rep.findings if f.rule == "obs-discipline")
    assert f.call == "obs.instant"
    assert "SPAN_SCOPES" in f.message


def test_obs_allows_span_calls_in_declared_scopes(tmp_path):
    rep = lint_snippet(tmp_path, "serving/batching.py", """
        class BatchedServingEngine:
            def _retire(self, r):
                self.obs.terminal(r.rid, r.finish_reason)

            def submit_request(self, r):
                self.obs.instant("request.queued", "lifecycle", rid=r.rid)
    """)
    assert [f for f in rep.findings if f.rule == "obs-discipline"] == []


def test_obs_allows_registry_mutation_and_view_reads(tmp_path):
    rep = lint_snippet(tmp_path, "serving/cluster.py", """
        class ReplicaPool:
            def migrate(self, rid, nbytes):
                self._c_handoffs.inc()
                self._c_handoff_bytes.inc(nbytes)
                total = self.n_handoffs + self.handoff_bytes  # reads are fine
                return total
    """)
    assert rep.findings == []


# --------------------------------------------------------------------------
# allowlist mechanics
# --------------------------------------------------------------------------


BAD_DECODE = """
    import numpy as np
    class BatchedServingEngine:
        def _decode_step(self, batch):
            ids_np = np.asarray(self.ids)
            extra = np.asarray(self.other)
            return ids_np, extra
"""


def test_allowlist_suppresses_only_the_pinned_arg(tmp_path):
    allow = [AllowEntry(rule="sync-point", reason="declared dispatch point",
                        path="serving/batching.py",
                        scope="BatchedServingEngine._decode_step",
                        call="np.asarray", arg="self.ids")]
    rep = lint_snippet(tmp_path, "serving/batching.py", BAD_DECODE, allow)
    assert len(rep.findings) == 1
    assert rep.findings[0].arg == "self.other"
    assert len(rep.suppressed) == 1
    assert rep.unused_allows == []


def test_allowlist_reports_unused_entries(tmp_path):
    allow = [AllowEntry(rule="sync-point", reason="stale",
                        path="serving/engine.py", scope="Gone.method")]
    rep = lint_snippet(tmp_path, "serving/batching.py", """
        class BatchedServingEngine:
            pass
    """, allow)
    assert rep.unused_allows == allow


def test_minimal_toml_parser_roundtrip(tmp_path):
    text = """
    # comment
    [[allow]]
    rule = "sync-point"
    path = "serving/engine.py"
    scope = "_logits_row"
    call = "logits.cpu"
    arg = "logits"
    reason = "has \\"quotes\\" and a # hash"
    [[allow]]
    rule = "emit-discipline"
    reason = "second entry"
    """
    data = _parse_toml_minimal(textwrap.dedent(text))
    assert len(data["allow"]) == 2
    assert data["allow"][0]["scope"] == "_logits_row"
    assert "# hash" in data["allow"][0]["reason"]
    p = tmp_path / "a.toml"
    p.write_text(textwrap.dedent(text))
    entries = load_allowlist(p)
    assert entries[0].arg == "logits" and entries[1].rule == "emit-discipline"


def test_allowlist_rejects_unknown_keys(tmp_path):
    p = tmp_path / "a.toml"
    p.write_text('[[allow]]\nrule = "sync-point"\nreason = "x"\nfile = "y"\n')
    with pytest.raises(ValueError, match="unknown keys"):
        load_allowlist(p)


# --------------------------------------------------------------------------
# the port's package: clean baseline + seeded violations
# --------------------------------------------------------------------------


def _real_allowlist():
    return load_allowlist(PACKAGE / "analysis" / "allowlist.toml")


def test_port_lints_clean():
    rep = run_lint(PACKAGE, ALL_RULES, _real_allowlist())
    assert rep.findings == [], "\n".join(f.format() for f in rep.findings)
    assert rep.unused_allows == []
    # every entry states its reason
    assert all(a.reason.strip() for a in _real_allowlist())


def _copy_package(tmp_path) -> Path:
    dst = tmp_path / "repro_torch"
    shutil.copytree(PACKAGE, dst, ignore=shutil.ignore_patterns("__pycache__"))
    return dst


SYNC_ANCHOR = "ids_np = ids.cpu().numpy().reshape(B, self.k)"


def _seed_sync(root):
    f = root / "serving" / "batching.py"
    src = f.read_text()
    assert SYNC_ANCHOR in src
    f.write_text(src.replace(SYNC_ANCHOR, SYNC_ANCHOR + "\n            _stall = x.cpu()", 1))


def test_seeded_sync_in_decode_step_is_caught(tmp_path):
    root = _copy_package(tmp_path)
    _seed_sync(root)
    rep = run_lint(root, ALL_RULES, _real_allowlist())
    assert len(rep.findings) == 1
    found = rep.findings[0]
    assert found.rule == "sync-point"
    assert found.path == "serving/batching.py"
    assert found.scope == "BatchedServingEngine._decode_step"
    assert found.call == "x.cpu" and found.line > 0


def test_seeded_kv_write_is_caught(tmp_path):
    root = _copy_package(tmp_path)
    f = root / "serving" / "batching.py"
    src = f.read_text()
    anchor = "def _sample_req(self, req"
    assert anchor in src
    idx = src.index(anchor)
    line_end = src.index("\n", src.index(":", idx))
    f.write_text(src[:line_end] + "\n        self._K[0] = None" + src[line_end:])
    rep = run_lint(root, ALL_RULES, _real_allowlist())
    assert "residency-discipline" in [x.rule for x in rep.findings]


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def test_cli_exit_codes(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["--list-rules"]) == 0
    assert main(["--no-audit"]) == 0
    root = _copy_package(tmp_path)
    _seed_sync(root)
    capsys.readouterr()
    code = main(["--no-audit", "--root", str(root),
                 "--allowlist", str(root / "analysis" / "allowlist.toml")])
    out = capsys.readouterr().out
    assert code == 1
    assert "sync-point" in out and "serving/batching.py:" in out


def test_cli_runs_the_cpu_audit(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "device audit (cpu): donation, compile-keys" in err


# --------------------------------------------------------------------------
# device audit (its host-side checks; the card's in tests/test_torch_cuda.py)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def audit_report():
    from repro_torch.analysis.device_audit import build_audit_engine, run_audit
    return run_audit(build=lambda: build_audit_engine("cpu"))


def test_device_audit_clean_on_cpu(audit_report):
    rep = audit_report
    assert rep.ok, "\n".join(f.format() for f in rep.findings)
    assert rep.checks == ["donation", "compile-keys"]
    assert rep.compile_keys <= rep.compile_key_bound
    assert rep.readings["donation"]["prefetched"] > 0
    assert rep.readings["donation"]["pool_ptrs_same"]


def test_device_audit_flags_an_out_of_place_pool_write():
    from repro_torch.analysis.device_audit import build_audit_engine, run_audit

    def out_of_place(cache, key):
        slot = cache.slot_of[key]
        for name, src in zip(("w1", "w3", "w2"), cache.store.get(key)):
            cache._pools[name] = cache._pools[name].clone()
            cache._pools[name][slot].copy_(src)
        cache._loaded.add(key)

    rep = run_audit(build=lambda: build_audit_engine("cpu"), extra={"donation": out_of_place})
    assert [f.rule for f in rep.findings] == ["donation"]
    assert "in place" in rep.findings[0].message


def test_device_audit_flags_an_unbucketed_dispatch():
    from repro_torch.analysis.device_audit import build_audit_engine, run_audit
    from repro_torch.serving.engine import group_by_expert

    def unbucketed(ids, union, bucket_cap, u_bucket_cap=None):
        d = group_by_expert(ids, union, bucket_cap=1 << 30)
        return dataclasses.replace(d, row_idx=d.row_idx[:len(union), :max(d.counts)])

    rep = run_audit(build=lambda: build_audit_engine("cpu"), extra={"compile-keys": unbucketed})
    assert [f.rule for f in rep.findings] == ["compile-keys"]


def test_compile_key_enumeration_matches_measurement():
    from repro_torch.analysis.device_audit import (compile_key_bound,
                                                    enumerate_grouped_keys,
                                                    measure_grouped_keys)
    B, E, k = 8, 8, 2
    keys = enumerate_grouped_keys(B, E, k)
    measured = measure_grouped_keys(B, E, k)
    assert measured <= keys
    assert len(keys) <= compile_key_bound(B, E, k)
    # every padded dim the buckets give is a power of two (or the clamp)
    for (b, U, C) in keys:
        assert U & (U - 1) == 0 or U == min(E, b * k)
        assert C & (C - 1) == 0 or C == b
