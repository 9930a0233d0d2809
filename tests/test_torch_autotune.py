"""The port's kernel-schedule autotuner against the JAX package's, on the CPU.

Mirrors JAX's own cases (``tests/test_fused.py`` ``TestAutotune``,
``tests/test_longbag.py`` ``test_autotune_softmax_axis_round_trips``,
``tests/test_ann.py``'s LUT round trips) and holds the two packages to one
cache format and one dispatch:

- ``cache_key()`` strings, schedule dicts and the file format are JAX's:
  a file either package writes loads in the other with equal schedules; a
  corrupt or version-skewed file is an empty cache;
- the dry round trip moves the counters as JAX's does, the CLI's ``--dry``
  / ``--expect-cached`` exit codes and printed schedules are JAX's, a timed
  search on the CPU space picks and persists a winner, a miss falls back
  without search, and an entry the port cannot run is a miss logged once;
- ``Code2Vec.resolve_kernel(batch, width)`` equals JAX ``_resolve_kernel``
  over cached schedule x ``pallas_softmax`` x width on both sides of
  ``longbag_width``; N forwards at one shape look it up once;
- the model under ``auto`` equals the fixed route its schedule names
  bitwise, and JAX's model under ``auto`` on the same cache file within
  rtol 2e-4 / atol 2e-5 (``tests/test_torch_model.py``'s bar);
- a tiny CLI train under ``auto`` has the fixed route's per-step losses,
  bit for bit; the engine's schedule records are JAX ``consult_schedules``'s;
- the LUT axis round trips and the searcher looks its schedule up;
- on a gloo ``data=2`` mesh each rank keys its lookup on the global batch.

The JAX side runs its compiled CPU strategy (``C2V_KERNEL_BACKEND=cpu``,
restored after each test), whose miss default is the port's.
"""

import json
import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code2vec_tpu.models.code2vec import Code2Vec as JaxCode2Vec
from code2vec_tpu.models.code2vec import Code2VecConfig as JaxConfig
from code2vec_tpu.ops import autotune as jat
from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig, route_config
from code2vec_tpu_torch.ops import autotune as at
from test_torch_model import DIMS, batch, compare, gspmd, jax_setup, port_model

REPO = str(Path(__file__).resolve().parents[1])
CPU = torch.device("cpu")
B, L = 5, 14  # test_torch_model.batch()'s shape

# (impl, softmax) of each route a cached schedule can name
ROUTES = {"xla": ("xla", "materialize"), "pool_only": ("pool_only", "materialize"),
          "gather_split": ("gather_split", "materialize"), "fused": ("fused", "materialize"),
          "online": ("fused", "online"), "two_pass": ("fused", "two_pass")}


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    """No pinned cache in either package, the default path inside
    ``tmp_path``, the JAX side on its compiled CPU strategy."""
    monkeypatch.setenv("C2V_KERNEL_BACKEND", "cpu")
    monkeypatch.setenv(at.DEFAULT_CACHE_ENV, str(tmp_path / "default.json"))
    at.reset_cache()
    jat.reset_cache()
    yield
    at.reset_cache()
    jat.reset_cache()


def key(batch=B, width=L, dt="f32", te=DIMS["terminal_embed_size"],
        pe=DIMS["path_embed_size"], h=DIMS["encode_size"], kind="cpu"):
    return at.ShapeKey(device_kind=kind, batch=batch, width=width, terminal_embed=te,
                       path_embed=pe, encode=h, table_dtype=dt)


def schedule(route, **kw):
    impl, softmax = ROUTES[route]
    return at.KernelSchedule(impl=impl, softmax=softmax, backend="cpu", **kw)


def write_cache(path, entries) -> at.ScheduleCache:
    cache = at.ScheduleCache(str(path))
    for k, s in entries:
        cache.put(k, s)
    cache.save()
    return cache


def delta(before):
    after = at.counters_snapshot()
    return {k: after[k] - before[k] for k in after}


def jdelta(before):
    after = jat.counters_snapshot()
    return {k: after[k] - before[k] for k in after}


# ---------------------------------------------------------------------------
# the cache format
# ---------------------------------------------------------------------------


class TestFormat:
    @pytest.mark.parametrize("fields", [
        dict(device_kind="cpu", batch=4, width=8, terminal_embed=6, path_embed=5, encode=12,
             table_dtype="f32"),
        dict(device_kind="NVIDIA H100 80GB HBM3", batch=1024, width=200, terminal_embed=100,
             path_embed=100, encode=100, table_dtype="int8"),
    ])
    def test_cache_keys_are_jaxs(self, fields):
        assert at.ShapeKey(**fields).cache_key() == jat.ShapeKey(**fields).cache_key()
        lut = dict(device_kind=fields["device_kind"], m=20, n_list=1000, capacity=1152,
                   shortlist=256)
        assert at.LutShapeKey(**lut).cache_key() == jat.LutShapeKey(**lut).cache_key()

    def test_schedules_constants_and_default_path_are_jaxs(self, tmp_path, monkeypatch):
        assert at.KernelSchedule().to_dict() == jat.KernelSchedule().to_dict()
        assert at.LutSchedule().to_dict() == jat.LutSchedule().to_dict()
        assert (at._CACHE_VERSION, at.DEFAULT_CACHE_ENV, at.IMPLS, at.LUT_IMPLS) == (
            jat._CACHE_VERSION, jat.DEFAULT_CACHE_ENV, jat.IMPLS, jat.LUT_IMPLS)
        assert at.default_cache_path() == jat.default_cache_path() == str(
            tmp_path / "default.json")
        monkeypatch.delenv(at.DEFAULT_CACHE_ENV)
        assert at.default_cache_path() == jat.default_cache_path()
        # pre-softmax / pre-backend entries load with the defaults, as in JAX
        old = {"impl": "fused", "block_b": 8, "unknown_field": 1}
        assert at.KernelSchedule.from_dict(old).to_dict() == \
            jat.KernelSchedule.from_dict(old).to_dict()

    def test_a_jax_written_file_loads_in_the_port(self, tmp_path):
        path = str(tmp_path / "jax.json")
        jcache = jat.ScheduleCache(path)
        fwd = [jat.ShapeKey("cpu", 4, w, 6, 5, 12, dt) for w in (8, 300) for dt in ("f32", "int8")]
        scheds = [jat.KernelSchedule(impl="gather_split", backend="cpu"),
                  jat.KernelSchedule(impl="fused", block_b=16, chunk_l=256, softmax="online",
                                     backend="tpu"),
                  jat.KernelSchedule(impl="xla"),
                  jat.KernelSchedule(impl="fused", softmax="two_pass", backend="interpret")]
        for k, s in zip(fwd, scheds):
            jcache.put(k, s, timings_ms={"xla": 1.0}, interpret=False)
        lut = jat.LutShapeKey("cpu", 4, 8, 128, 32)
        jcache.put(lut, jat.LutSchedule(impl="pallas", chunk_c=256, dma_depth=1, backend="tpu"))
        jcache.save()
        cache = at.ScheduleCache(path)
        assert cache.entries == json.load(open(path))["entries"]
        jcache = jat.ScheduleCache(path)
        for k in fwd:
            pk = at.ShapeKey(**vars(k))
            assert cache.get(pk).to_dict() == jcache.get(k).to_dict()
        assert cache.get_lut(at.LutShapeKey(**vars(lut))).to_dict() == \
            jcache.get_lut(lut).to_dict()

    def test_a_port_written_file_loads_in_jax(self, tmp_path):
        path = str(tmp_path / "port.json")
        keys = at.keys_for(4, [8, 16], 4, 4, 8, ["f32", "bf16"], device=CPU)
        at.autotune(keys[:2], cache=at.ScheduleCache(path), iters=1, repeats=1, vocab=32,
                    device=CPU)
        cache = at.ScheduleCache(path)
        cache.put(keys[2], schedule("two_pass"))
        lut = at.LutShapeKey("cpu", 2, 4, 128, 16)
        at.autotune_lut([lut], cache=cache, dry=True, device=CPU)
        jcache = jat.ScheduleCache(path)
        assert jcache.entries == cache.entries
        for k in keys[:3]:
            assert jcache.get(jat.ShapeKey(**vars(k))).to_dict() == cache.get(k).to_dict()
        assert jcache.get_lut(jat.LutShapeKey(**vars(lut))).to_dict() == \
            cache.get_lut(lut).to_dict()

    @pytest.mark.parametrize("text", ["{corrupt", json.dumps({"version": 99, "entries": {}}),
                                      json.dumps({"version": 1, "entries": []})],
                             ids=["corrupt", "version", "entries"])
    def test_a_bad_file_is_an_empty_cache(self, tmp_path, text):
        path = tmp_path / "bad.json"
        path.write_text(text)
        assert at.ScheduleCache(str(path)).entries == jat.ScheduleCache(str(path)).entries == {}


# ---------------------------------------------------------------------------
# search, lookup, the CLI
# ---------------------------------------------------------------------------


class TestSearch:
    def test_dry_round_trip_counts_as_jaxs(self, tmp_path):
        got, want = [], []
        for mod, snap, kw, name in ((at, at.counters_snapshot, {"device": CPU}, "port"),
                                    (jat, jat.counters_snapshot, {}, "jax")):
            path = str(tmp_path / f"{name}.json")
            keys = mod.keys_for(4, [8, 16], 6, 5, 12, ["f32"], **kw)
            before = snap()
            first = mod.autotune(keys, cache=mod.ScheduleCache(path), dry=True, **kw)
            mid = snap()
            second = mod.autotune(keys, cache=mod.ScheduleCache(path), dry=True, **kw)
            after = snap()
            out = got if mod is at else want
            out.append(({k: mid[k] - before[k] for k in mid},
                        {k: after[k] - mid[k] for k in mid},
                        {k: s.to_dict() for k, s in first.items()},
                        {k: s.to_dict() for k, s in second.items()}))
        assert got == want
        first_delta, second_delta = got[0][:2]
        assert (first_delta["autotune_cache_miss"], first_delta["autotune_schedule_stored"]) \
            == (2, 2)
        assert (second_delta["autotune_cache_hit"], second_delta["autotune_cache_miss"],
                second_delta["autotune_timing_run"]) == (2, 0, 0)

    def test_cli_dry_and_expect_cached(self, tmp_path, capsys):
        argv = ["--autotune", "--dry", "--backend", "cpu", "--batch", "4", "--widths", "8",
                "--terminal-embed", "4", "--path-embed", "4", "--encode", "8"]
        port = argv + ["--cache", str(tmp_path / "port.json")]
        jax_argv = argv + ["--cache", str(tmp_path / "jax.json")]
        assert at.main(port) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert jat.main(jax_argv) == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert got["schedules"] == want["schedules"] and got["counters"] == want["counters"]
        assert got["device_kind"] == want["device_kind"] == "cpu"
        assert at.main(port + ["--expect-cached"]) == 0
        assert json.loads(capsys.readouterr().out.strip())["counters"][
            "autotune_timing_run"] == 0
        new_shape = [a if a != "8" else "16" for a in port]
        assert at.main(new_shape + ["--expect-cached"]) == 2
        assert jat.main([a if a != "8" else "16" for a in jax_argv] + ["--expect-cached"]) == 2
        assert at.main(["--dry", "--lut", "--backend", "cpu", "--cache",
                        str(tmp_path / "port.json")]) == 0
        assert at.main(["--lut", "--expect-cached", "--backend", "cpu", "--cache",
                        str(tmp_path / "port.json")]) == 0

    def test_cli_runs_on_the_card_unless_asked(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            at.main(["--dry", "--cache", str(tmp_path / "c.json")])
        with pytest.raises(SystemExit):
            at.main(["--dry", "--backend", "tpu", "--cache", str(tmp_path / "c.json")])

    def test_module_cli_in_a_subprocess(self, tmp_path):
        argv = [sys.executable, "-m", "code2vec_tpu_torch.ops.autotune", "--dry", "--backend",
                "cpu", "--cache", str(tmp_path / "c.json"), "--batch", "2", "--widths", "4"]
        for extra, rc in (([], 0), (["--expect-cached"], 0),
                          (["--expect-cached", "--encode", "32"], 2)):
            proc = subprocess.run(argv + extra, cwd=REPO, capture_output=True, text=True,
                                  timeout=120)
            assert proc.returncode == rc, proc.stderr
        assert "jax" not in proc.stdout

    def test_the_cpu_space_is_jaxs_at_one_block(self):
        got = at.enumerate_variants(8, 300, "f32", device=CPU)
        want = [v for v in jat.enumerate_variants(8, 300, "f32") if v.block_b == 8]
        assert [v.to_dict() for v in got] == [v.to_dict() for v in want]
        assert [at._variant_label(v) for v in got] == [jat._variant_label(v) for v in want]
        # the card's space: the plain route and every kernel route, JAX's labels
        gpu = [at.KernelSchedule(impl="pool_only", backend="gpu"),
               at.KernelSchedule(impl="fused", softmax="two_pass", backend="gpu")]
        for s in gpu:
            assert at._variant_label(s) == jat._variant_label(jat.KernelSchedule(**s.to_dict()))

    def test_timed_search_picks_and_persists_a_winner(self, tmp_path):
        cache = at.ScheduleCache(str(tmp_path / "sched.json"))
        keys = at.keys_for(4, [8], 4, 4, 8, ["f32"], device=CPU)
        before = at.counters_snapshot()
        out = at.autotune(keys, cache=cache, iters=1, repeats=1, vocab=64, device=CPU)
        d = delta(before)
        assert d["autotune_timing_run"] == 2 and d["autotune_schedule_stored"] == 1
        (sched,) = out.values()
        assert sched.impl in at.IMPLS and sched.source == "autotune"
        (stored,) = json.load(open(cache.path))["entries"].values()
        timings = stored["timings_ms"]
        assert set(timings) == {"xla@cpu", "gather_split/b8@cpu"}
        assert at._variant_label(sched) == min(timings, key=timings.get)
        assert stored["schedule"] == sched.to_dict()
        reloaded = at.ScheduleCache(cache.path).get(keys[0])
        assert reloaded == at.KernelSchedule(**{**sched.to_dict(), "source": "cache"})

    def test_a_variant_that_raises_is_skipped_and_named(self, tmp_path, monkeypatch, capsys):
        real = at.time_variant

        def failing(variant, inputs, **kw):
            if variant.impl == "xla":
                raise RuntimeError("no route")
            return real(variant, inputs, **kw)

        monkeypatch.setattr(at, "time_variant", failing)
        cache = at.ScheduleCache(str(tmp_path / "sched.json"))
        (sched,) = at.autotune(at.keys_for(2, [4], 4, 4, 8, ["f32"], device=CPU), cache=cache,
                               iters=1, repeats=1, vocab=16, device=CPU).values()
        assert sched.impl == "gather_split"
        (stored,) = cache.entries.values()
        assert np.isnan(stored["timings_ms"]["xla@cpu"])
        assert "variant xla@cpu failed" in capsys.readouterr().err

    def test_a_miss_falls_back_without_search(self, tmp_path):
        cache = at.ScheduleCache(str(tmp_path / "empty.json"))
        before = at.counters_snapshot()
        sched = at.lookup_schedule(4, 99, 6, 5, 12, cache=cache, device=CPU)
        assert sched == at.default_schedule(CPU) and sched.source == "default"
        assert sched.to_dict() == jat.default_schedule().to_dict()
        assert delta(before) == {"autotune_cache_hit": 0, "autotune_cache_miss": 1,
                                 "autotune_timing_run": 0, "autotune_schedule_stored": 0}
        jbefore = jat.counters_snapshot()
        jat.lookup_schedule(4, 99, 6, 5, 12, cache=jat.ScheduleCache(cache.path))
        assert jdelta(jbefore) == delta(before)

    @pytest.mark.parametrize("entry", [
        {"impl": "gather_split", "block_b": 16, "backend": "cpu"},
        {"impl": "fused", "chunk_l": 256, "backend": "cpu"},
        {"impl": "fused", "dma_depth": 1, "backend": "auto"},
        {"impl": "pool_only", "backend": "tpu"},
        {"impl": "fused", "backend": "interpret"},
        {"impl": "gather_split", "backend": "gpu"},
    ], ids=["block_b", "chunk_l", "dma_depth", "tpu", "interpret", "gpu_on_cpu"])
    def test_an_entry_the_port_cannot_run_is_a_miss_logged_once(self, tmp_path, caplog,
                                                                  entry):
        cache = write_cache(tmp_path / "c.json", [(key(), at.KernelSchedule(**entry))])
        caplog.set_level(logging.WARNING, logger=at.__name__)
        before = at.counters_snapshot()
        for _ in range(2):
            assert at.lookup_schedule(B, L, DIMS["terminal_embed_size"],
                                      DIMS["path_embed_size"], DIMS["encode_size"],
                                      cache=cache, device=CPU) == at.default_schedule(CPU)
        assert delta(before)["autotune_cache_miss"] == 2
        assert delta(before)["autotune_cache_hit"] == 0
        assert len([r for r in caplog.records if "cannot run here" in r.message]) <= 1
        at._LOGGED.clear()
        # JAX runs what it wrote: a hit there
        jbefore = jat.counters_snapshot()
        jat.lookup_schedule(B, L, DIMS["terminal_embed_size"], DIMS["path_embed_size"],
                            DIMS["encode_size"], cache=jat.ScheduleCache(cache.path))
        assert jdelta(jbefore)["autotune_cache_hit"] == 1


# ---------------------------------------------------------------------------
# the model under pallas_impl="auto"
# ---------------------------------------------------------------------------


class TestModel:
    @pytest.mark.parametrize("width", [16, 40])
    @pytest.mark.parametrize("softmax", ["auto", "materialize", "online", "two_pass"])
    @pytest.mark.parametrize("cached", [None, *ROUTES])
    def test_resolve_kernel_matches_jax(self, tmp_path, cached, softmax, width):
        entries = [] if cached is None else [(key(2, width), schedule(cached))]
        write_cache(tmp_path / "c.json", entries)
        at.get_cache(str(tmp_path / "c.json"))
        jat.get_cache(str(tmp_path / "c.json"))
        kw = dict(DIMS, use_pallas=True, pallas_impl="auto", pallas_softmax=softmax,
                  longbag_width=32)
        _, sched = JaxCode2Vec(JaxConfig(**kw))._resolve_kernel(2, width)
        assert Code2Vec(Code2VecConfig(**kw)).resolve_kernel(2, width) == (sched.impl,
                                                                          sched.softmax)

    def test_a_shape_is_looked_up_once(self, tmp_path):
        """As JAX's jitted forward consults the cache once per traced shape."""
        path = str(tmp_path / "c.json")
        write_cache(path, [(key(), schedule("gather_split"))])
        at.get_cache(path)
        jat.get_cache(path)
        jm, params = jax_setup(route="auto")
        fn = jax.jit(lambda prm, *ids: jm.apply({"params": prm}, *ids))
        model = port_model(params, route="auto")
        ids = batch()
        jbefore, before = jat.counters_snapshot(), at.counters_snapshot()
        with gspmd(), torch.no_grad():
            for _ in range(4):
                fn(params, *(jnp.asarray(x) for x in ids))
                model(*(torch.from_numpy(x) for x in ids))
        assert delta(before) == jdelta(jbefore)
        assert delta(before)["autotune_cache_hit"] == 1
        s, p, e = (torch.from_numpy(x[:2, :8]) for x in ids)
        with torch.no_grad():
            model(s, p, e)
            model(s, p, e)
        d = delta(before)
        assert (d["autotune_cache_hit"], d["autotune_cache_miss"]) == (1, 1)
        # a newly pinned cache is consulted afresh
        at.get_cache(str(tmp_path / "other.json"))
        with torch.no_grad():
            model(s, p, e)
        assert delta(before)["autotune_cache_miss"] == 2

    @pytest.mark.parametrize("route,table_dtype", [
        *((r, "f32") for r in ROUTES), ("gather_split", "int8"), ("fused", "bf16")])
    def test_auto_is_the_fixed_route_and_jaxs_auto(self, tmp_path, route, table_dtype):
        path = str(tmp_path / "c.json")
        write_cache(path, [(key(dt=table_dtype), schedule(route))])
        at.get_cache(path)
        jat.get_cache(path)
        jm, params = jax_setup(route="auto", table_dtype=table_dtype)
        model = port_model(params, route="auto", table_dtype=table_dtype)
        assert model.resolve_kernel(B, L) == ROUTES[route]
        compare(jm, params, model)
        fixed = Code2Vec(route_config(model.config, schedule(route)))
        fixed.load_state_dict(model.state_dict())
        fixed.eval()
        ids = [torch.from_numpy(x) for x in batch(seed=3)]
        with torch.no_grad():
            for got, want in zip(model(*ids), fixed(*ids)):
                assert torch.equal(got, want)

    def test_config_and_cli_accept_auto(self, tmp_path):
        from code2vec_tpu_torch import cli
        from code2vec_tpu_torch.serve.__main__ import build_parser as serve_parser
        from code2vec_tpu_torch.serve.fleet.__main__ import build_parser as fleet_parser
        from code2vec_tpu_torch.serve.fleet.__main__ import worker_argv

        args = cli.build_parser().parse_args(["--use_pallas", "--pallas_impl", "auto",
                                              "--autotune_cache", "at.json"])
        config = cli.config_from_args(args).validate()
        assert (config.pallas_impl, config.autotune_cache) == ("auto", "at.json")
        common = ["--model_path", "m", "--terminal_idx_path", "t", "--path_idx_path", "p",
                  "--pallas_impl", "auto", "--autotune_cache", "at.json"]
        assert serve_parser().parse_args(common).autotune_cache == "at.json"
        argv = worker_argv(fleet_parser().parse_args(common), 0)
        assert argv[argv.index("--autotune_cache") + 1] == "at.json"
        assert argv[argv.index("--pallas_impl") + 1] == "auto"


# ---------------------------------------------------------------------------
# training, serving and search under auto
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--synthetic", "tiny", "--max_epoch", "1", "--batch_size", "16",
        "--max_path_length", "20", "--terminal_embed_size", "8", "--path_embed_size", "8",
        "--encode_size", "16", "--print_sample_cycle", "0", "--random_seed", "4"]


def cli_losses(monkeypatch, argv) -> list:
    """Per-step losses of an in-process CLI run (the loop's step, wrapped)."""
    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.train import loop

    losses, real = [], loop.train_step

    def recording(model, optimizer, batch, class_weights):
        loss = real(model, optimizer, batch, class_weights)
        losses.append(float(loss))
        return loss

    monkeypatch.setattr(loop, "train_step", recording)
    assert cli.main(argv) == 0
    monkeypatch.setattr(loop, "train_step", real)
    return losses


@pytest.mark.parametrize("route", ["xla", "gather_split", "two_pass"])
def test_cli_train_under_auto_is_the_fixed_route(tmp_path, monkeypatch, route):
    path = str(tmp_path / "c.json")
    write_cache(path, [(key(16, 20, te=8, pe=8, h=16), schedule(route))])
    before = at.counters_snapshot()
    auto = cli_losses(monkeypatch, TINY + [
        "--use_pallas", "--pallas_impl", "auto", "--autotune_cache", path,
        "--model_path", str(tmp_path / "auto"), "--vectors_path", str(tmp_path / "a.vec")])
    assert delta(before)["autotune_cache_hit"] >= 1
    assert at.get_cache().path == path
    impl, softmax = ROUTES[route]
    fixed_flags = [] if impl == "xla" else ["--use_pallas", "--pallas_impl", impl,
                                            "--pallas_softmax", softmax]
    fixed = cli_losses(monkeypatch, TINY + fixed_flags + [
        "--model_path", str(tmp_path / "fixed"), "--vectors_path", str(tmp_path / "f.vec")])
    assert len(auto) > 3 and auto == fixed


def test_engine_records_are_jaxs_consult(tmp_path):
    from test_torch_serve import DIMS as SDIMS
    from test_torch_serve import make_model_dir, server_for

    (tmp_path / "m").mkdir()
    path, _, _ = make_model_dir(tmp_path / "m")
    cache_path = str(tmp_path / "c.json")
    dims = dict(te=SDIMS["terminal_embed_size"], pe=SDIMS["path_embed_size"],
                h=SDIMS["encode_size"])
    cached = {(1, 8): "online", (8, 16): "gather_split", (1, 16): "xla"}
    write_cache(cache_path, [(key(b, w, **dims), schedule(r)) for (b, w), r in cached.items()])
    srv = server_for(path, "--pallas_impl", "auto", "--autotune_cache", cache_path)
    try:
        records = {(r["batch"], r["width"]): r for r in srv.engine.provenance}
        assert set(records) == {(b, w) for b in (1, 8) for w in (8, 16)}
        jkeys = [jat.ShapeKey("cpu", b, w, dims["te"], dims["pe"], dims["h"], "f32")
                 for b, w in records]
        want = jat.consult_schedules(jkeys, cache=jat.ScheduleCache(cache_path))
        for (shape, rec), w in zip(records.items(), want):
            assert (rec["schedule"], rec["schedule_cached"]) == (w["schedule"], w["cached"])
            assert rec["schedule_cached"] == (shape in cached)
            assert rec["kernel_backend"] == "cpu"
        # each shape's answers are the fixed route's its schedule names, bit for bit
        engine, predictor = srv.engine, srv.predictor
        rng = np.random.default_rng(0)
        for (b, w), rec in records.items():
            ids = rng.integers(1, SDIMS["path_count"], (3, b, w)).astype(np.int32)
            got = engine.run(*ids)
            fixed = Code2Vec(route_config(predictor.config,
                                          at.KernelSchedule.from_dict(rec["schedule"])
                                          if rec["schedule_cached"]
                                          else at.KernelSchedule(impl="pool_only")))
            fixed.load_state_dict(predictor.model.state_dict())
            fixed.eval()
            with torch.no_grad():
                want_out = fixed(*(torch.from_numpy(x) for x in ids))
            for g, x in zip(got, want_out):
                assert np.array_equal(g, x.numpy())
    finally:
        srv.close()


def test_lut_round_trip_and_the_searchers_lookup(tmp_path):
    from code2vec_tpu_torch.ann.index import AnnSearcher, build_index

    rows = np.random.default_rng(0).normal(size=(600, 16)).astype(np.float32)
    index, _ = build_index(rows, n_list=8, m=4, seed=0, kmeans_iters=3, pq_iters=3,
                           device=CPU)
    meta = index.meta
    lut = at.LutShapeKey("cpu", meta["m"], meta["n_list"], meta["capacity"], 32)
    path = str(tmp_path / "lut.json")
    before = at.counters_snapshot()
    (dry,) = at.autotune_lut([lut], cache=at.ScheduleCache(path), dry=True,
                             device=CPU).values()
    assert dry.to_dict() == jat.LutSchedule(impl="xla", backend="cpu", source="dry").to_dict()
    found = at.lookup_lut_schedule(lut.m, lut.n_list, lut.capacity, lut.shortlist,
                                   cache=at.ScheduleCache(path), device=CPU)
    jfound = jat.lookup_lut_schedule(lut.m, lut.n_list, lut.capacity, lut.shortlist,
                                     cache=jat.ScheduleCache(path))
    assert found.source == "cache" and found.to_dict() == jfound.to_dict()
    d = delta(before)
    assert (d["autotune_cache_miss"], d["autotune_cache_hit"], d["autotune_timing_run"]) == (
        1, 1, 0)
    assert all(k.startswith("lut|") for k in at.ScheduleCache(path).entries)
    # a timed search over the CPU's one variant
    timed = at.autotune_lut([lut], cache=at.ScheduleCache(path), force=True, iters=1,
                            repeats=1, n_probe=2, q_batch=2, device=CPU)
    assert timed[lut.cache_key()].source == "autotune"
    assert set(at.ScheduleCache(path).entries[lut.cache_key()]["timings_ms"]) == {"xla@cpu"}

    searcher = AnnSearcher(index, n_probe=4, shortlist=32, device=CPU,
                           cache=at.ScheduleCache(path))
    assert searcher.describe()["schedule"] == {**found.to_dict(), "source": "cache"}
    assert searcher.describe()["kernel_backend"] == "cpu"
    # a K5 entry for a searcher on the CPU cannot run there: a miss, the default
    other = write_cache(tmp_path / "k5.json",
                        [(lut, at.LutSchedule(impl="pallas", backend="gpu"))])
    plain = AnnSearcher(index, n_probe=4, shortlist=32, device=CPU, cache=other)
    assert plain.schedule == at.default_lut_schedule(CPU)
    q = rows[:5]
    for a, b in zip(plain.search(q), searcher.search(q)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="cannot run"):
        AnnSearcher(index, device=CPU, schedule=at.LutSchedule(impl="pallas", backend="gpu"))


def test_a_data2_mesh_keys_on_the_global_batch(tmp_path):
    import test_torch_mesh as harness

    dims = harness.DIMS
    batches = harness.make_batches(dims, n=1)
    model = Code2Vec(Code2VecConfig(**dims, dropout_prob=0.0))
    model.reset_parameters(torch.Generator().manual_seed(2))
    inputs = tmp_path / "inputs.pt"
    torch.save({"state_dict": model.state_dict(), "batches": batches}, inputs)
    shape = dict(te=dims["terminal_embed_size"], pe=dims["path_embed_size"],
                 h=dims["encode_size"])
    cache = tmp_path / "c.json"
    # the global batch's schedule, and a decoy at the rows one rank holds
    write_cache(cache, [(key(harness.B, harness.L, **shape), schedule("gather_split")),
                        (key(harness.B // 2, harness.L, **shape), schedule("two_pass"))])
    results = harness.spawn(tmp_path, "autotune", 2, axes=[2, 1, 1], model=dims,
                            inputs=str(inputs), cache=str(cache))
    fixed = Code2Vec(route_config(model.config, schedule("gather_split"))).eval()
    fixed.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = fixed(*(torch.from_numpy(batches[0][k]) for k in ("starts", "paths", "ends")))[1]
    rows = harness.B // 2
    for rank, res in enumerate(results):
        assert res["local_rows"] == rows
        assert res["resolved"] == [((harness.B, harness.L), ("gather_split", "materialize"))]
        assert (res["counters"]["autotune_cache_hit"],
                res["counters"]["autotune_cache_miss"]) == (1, 0)
        assert torch.equal(res["code_vectors"][0], res["code_vectors"][1])
        torch.testing.assert_close(res["code_vectors"][0], want[rank * rows:(rank + 1) * rows],
                                   rtol=1e-6, atol=1e-7)
