"""The port's codec against the reference's on the same numpy inputs: leaf
plans and pack-plan slot tables field by field, ``make_step_inputs`` exactly,
``encode_leaf`` and the packed / per-leaf decode of both encoding schedules
at the kernels' f32 tolerance; and, inside the port, packed == per-leaf
bitwise and the collective count per bucket.

The reference side runs as its own tests run it on the CPU: a ``shard_map``
over the forced host devices of ``tests/conftest.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.coding as jc
import repro.core as jcore
import repro_torch.coding as tc
import repro_torch.core as tcore
from repro.compat import make_mesh, shard_map
from repro_torch import convert
from repro_torch.comm import make_local_comm

torch.set_num_threads(1)

N, M = 4, 2
JCODE = jcore.make_code(N, 3, 1, M)
TCODE = tcore.make_code(N, 3, 1, M)
MIXED_SHAPES = [(64,), (6, 8, 5), (7,), (16, 3)]   # (7,) -> psum fallback
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL = dict(rtol=2e-5, atol=2e-5)   # same f32 products, other sum order


def _trees(shapes):
    jt = {f"p{i}": jax.ShapeDtypeStruct(s, jnp.float32)
          for i, s in enumerate(shapes)}
    tt = {f"p{i}": torch.empty(s, device="meta") for i, s in enumerate(shapes)}
    return jt, tt


def _to_t(x, dtype=None):
    t = torch.from_numpy(np.array(x, np.float32))
    return t.to(dtype) if dtype is not None else t


# ------------------------------------------------------------ static tables
@pytest.mark.parametrize("n_split", [1, N])
@pytest.mark.parametrize("shapes", [MIXED_SHAPES, [(343474,)],
                                    [(128, 256), (256,), (3, 5)]])
def test_plan_tree_equals_reference(shapes, n_split):
    jt, tt = _trees(shapes)
    jp = jc.plan_tree(jt, None, M, n_split)
    tp = tc.plan_tree(tt, M, n_split)
    assert list(jp) == list(tp)
    for k in jp:
        assert dataclasses.asdict(jp[k]) == dataclasses.asdict(tp[k])
    assert jc.coded_fraction(jt, jp) == tc.coded_fraction(tt, tp)


@functools.lru_cache(maxsize=None)
def _model_trees(name, reduced):
    """A config's parameter shapes on both sides, and the reference's
    PartitionSpecs at a model axis of 1, flattened to the port's keys."""
    from repro.configs import get_config as jget_config
    from repro.models import api as japi
    from repro.train import sharding
    from repro_torch.configs import get_config as tget_config
    from repro_torch.models import api as tapi
    jcfg, tcfg = jget_config(name), tget_config(name)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jt = jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0), jcfg))
    jspecs = sharding.param_specs(jt, 1)
    flat = convert.flatten(jax.tree.map(
        tuple, jspecs, is_leaf=lambda v: isinstance(v, P)))
    return jt, jspecs, flat, tapi.init(tcfg, "meta")


def _config_names():
    from repro_torch.configs import list_configs
    return list(list_configs())


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("name", _config_names())
def test_param_specs_are_the_references(name, reduced):
    """The port's copy of the reference's tensor-parallel layout gives every
    leaf of every config the reference's specs at a model axis of 1."""
    _, _, want, tt = _model_trees(name, reduced)
    got = tc.param_specs(tt)
    assert list(got) == list(want)
    for k in got:
        assert got[k] == tuple(want[k]), k


@pytest.mark.parametrize("m, n_split", [(1, 1), (2, 1), (3, 1), (2, N)])
@pytest.mark.parametrize("name", _config_names())
def test_model_plans_are_the_references(name, m, n_split):
    """With the specs, the port groups every leaf of every model on the dim
    the reference's step groups it on: the dims the reference shards over
    its model axis (d_ff, vocab, heads) are skipped at a model axis of 1
    too, so a partial decode pairs the same coordinates on both sides."""
    for reduced in (True, False):
        jt, jspecs, _, tt = _model_trees(name, reduced)
        jp = convert.flatten(jc.plan_tree(jt, jspecs, m, n_split))
        tp = tc.plan_tree(tt, m, n_split, tc.param_specs(tt))
        assert list(jp) == list(tp)
        for k in tp:
            assert dataclasses.asdict(jp[k]) == dataclasses.asdict(tp[k]), k
        assert jc.coded_fraction(jt, jc.plan_tree(jt, jspecs, m, n_split)) \
            == tc.coded_fraction(tt, tp)


def test_rule_is_the_references_copy():
    """The port's ``_rule`` is the reference's, statement for statement."""
    import ast
    import inspect
    import repro.train.sharding as jsharding
    import repro_torch.coding.plan as tplan
    dump = lambda f: ast.dump(ast.parse(inspect.getsource(f)))
    assert dump(tplan._rule) == dump(jsharding._rule)
    assert tplan._STACKS == jsharding._STACKS


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("shapes", [MIXED_SHAPES, [(343474,)],
                                    [(128, 256), (256,), (3, 5)]])
def test_pack_plan_slot_tables_equal_reference(shapes, n, wire):
    jt, tt = _trees(shapes)
    jp = jc.plan_tree(jt, None, M)
    tp = tc.plan_tree(tt, M)
    a = jc.make_pack_plan(jt, jp, m=M, n=n, wire_dtype=wire)
    b = tc.make_pack_plan(tt, tp, m=M, n=n, wire_dtype=wire)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.padded_elems, a.unpadded_elems, a.num_coded_leaves) == \
        (b.padded_elems, b.unpadded_elems, b.num_coded_leaves)
    for ba, bb in zip(a.buckets, b.buckets):
        assert ba.worker_chunk_slots(n) == bb.worker_chunk_slots(n)
    for name in ("gather", "a2a", "psum"):
        assert a.recv_elems_per_worker(jc.get_schedule(name)) == \
            b.recv_elems_per_worker(tc.get_schedule(name))


def test_full_width_bucket_is_padded_to_lcm():
    """l = 343474 with m = 2, n = 8: V = 171737 -> L = 171776."""
    tt = {"beta": torch.empty((343474,), device="meta")}
    pp = tc.make_pack_plan(tt, tc.plan_tree(tt, 2), m=2, n=8)
    (b,) = pp.buckets
    assert (b.unpadded, b.size, b.padding) == (171737, 171776, 39)
    # the a2a schedule cannot code this leaf at n = 8: nothing divides
    assert not tc.plan_tree(tt, 2, 8)["beta"].coded


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("stragglers", [(), (1,), (0, 3), (1, 2, 3)])
def test_make_step_inputs_equal_exactly(stragglers, partial):
    jcode, tcode = jcore.make_code(8, 4, 2, 2), tcore.make_code(8, 4, 2, 2)
    if len(stragglers) > 2 and not partial:
        with pytest.raises(ValueError):
            tc.make_step_inputs(tcode, stragglers)
        return
    a = jc.make_step_inputs(jcode, stragglers, partial=partial)
    b = tc.make_step_inputs(tcode, stragglers, partial=partial)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert jc.uncovered_subsets(jcode, stragglers) == \
        tc.uncovered_subsets(tcode, stragglers)


def test_admit_code():
    assert tc.admit_code(TCODE, n_data=N) is TCODE
    with pytest.raises(ValueError):
        tc.admit_code(TCODE, n_data=N + 1)


# ------------------------------------------------------------ pack / unpack
def test_pack_unpack_roundtrip_and_zero_padding():
    rng = np.random.default_rng(3)
    tree = {"a": _to_t(rng.standard_normal((64,))),
            "b": _to_t(rng.standard_normal((6, 8, 5)))}
    plans = tc.plan_tree(tree, M)
    enc = [tc.encode_leaf(x, torch.ones(M), plans[k])
           for k, x in tree.items()]
    pp = tc.make_pack_plan(tree, plans, m=M, n=N)
    (bucket,) = pp.buckets
    buf = tc.pack_bucket(enc, bucket, torch.float32)
    assert buf.shape == (bucket.size,)
    covered = torch.zeros(bucket.size, dtype=torch.bool)
    for s, e in zip(bucket.slots, enc):
        assert torch.equal(buf[s.offset:s.offset + s.size], e.reshape(-1))
        covered[s.offset:s.offset + s.size] = True
    assert torch.all(buf[~covered] == 0) and int((~covered).sum()) == bucket.padding
    dec = torch.stack([buf, buf], dim=1)        # a decode that copies
    out = tc.unpack_bucket(dec, bucket)
    for s, (k, x) in zip(bucket.slots, tree.items()):
        assert out[s.leaf_index].shape == x.shape


def test_param_groups_roundtrip():
    rng = np.random.default_rng(4)
    tree = {"a": _to_t(rng.standard_normal((64,))),
            "b": _to_t(rng.standard_normal((6, 8, 5)), torch.bfloat16)}
    plans = tc.plan_tree(tree, M)
    pp = tc.make_pack_plan(tree, plans, m=M, n=N)
    flat = list(tree.values())
    buf = tc.pack_param_groups(flat, pp.buckets[0], M)
    assert buf.shape == (pp.buckets[0].size, M) and buf.dtype == torch.float32
    back = tc.unpack_param_groups(buf, pp.buckets[0], flat)
    for i, x in enumerate(flat):
        assert back[i].dtype == x.dtype and torch.equal(back[i], x)


# ------------------------------------------------------ encode / decode vs jax
@pytest.mark.parametrize("shape,gdim", [((64,), 0), ((6, 8, 5), 1),
                                        ((16, 3), 0), ((4, 10, 6), 2)])
def test_encode_leaf_matches_reference(shape, gdim):
    rng = np.random.default_rng([1, *shape])
    g = rng.standard_normal(shape).astype(np.float32)
    coef = rng.standard_normal((M,)).astype(np.float32)
    want = jc.encode_leaf(jnp.asarray(g), jnp.asarray(coef),
                          jc.LeafPlan(True, gdim))
    got = tc.encode_leaf(_to_t(g), _to_t(coef), tc.LeafPlan(True, gdim))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _decode_both(shapes, schedule, wire, seed=0):
    """The same stacked per-worker payloads through the reference (packed,
    under shard_map) and the port (packed and per-leaf, LocalComm)."""
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} devices")
    jt, tt = _trees(shapes)
    jcodec = jc.make_codec(JCODE, schedule=schedule, backend="ref",
                           wire_dtype=wire)
    tcodec = tc.make_codec(TCODE, schedule=schedule, backend="auto",
                           wire_dtype=wire, device="cpu")
    jplans = jcodec.plan(jt)
    tplans = tcodec.plan(tt)
    jflat_plans = [jplans[k] for k in sorted(jt)]
    tflat_plans = [tplans[k] for k in tt]
    jpp, tpp = jcodec.pack_plan(jt, jplans), tcodec.pack_plan(tt, tplans)

    rng = np.random.default_rng(seed)
    wdt = jnp.dtype(wire)
    stacked = [jnp.asarray(rng.standard_normal(
                   (N,) + (jc.enc_shape(s, pl, M) if pl.coded else tuple(s))),
                   wdt if pl.coded else jnp.float32)
               for s, pl in zip(shapes, jflat_plans)]
    W = rng.standard_normal((N, M)).astype(np.float32)

    def packed(Wf, *fs):
        flat = [f[0] for f in fs]
        bufs = jcodec.pack(flat, jpp)
        decs = [jcodec.decode_packed(b, Wf, ("data",)) for b in bufs]
        out = list(flat)
        for i, g in jcodec.unpack(decs, jpp).items():
            out[i] = g
        for i, g in jc.psum_fallback(flat, jflat_plans, ("data",)).items():
            out[i] = g
        return tuple(out)

    mesh = make_mesh((N,), ("data",))
    specs = (P(),) + tuple(P("data") for _ in stacked)
    want = jax.jit(shard_map(
        packed, mesh=mesh, in_specs=specs,
        out_specs=tuple(P() for _ in stacked), axis_names={"data"},
        check_vma=False))(jnp.asarray(W), *stacked)

    comm = make_local_comm(N, "cpu")
    tstacked = [_to_t(x, TDT[wire] if pl.coded else torch.float32)
                for x, pl in zip(stacked, tflat_plans)]
    Wt = torch.from_numpy(W)
    bufs = [torch.stack(rows) for rows in zip(*(
        tcodec.pack([f[i] for f in tstacked], tpp) for i in range(N)))]
    decs = [tcodec.decode_packed(b, Wt, comm) for b in bufs]
    counts = dict(comm.counts)
    got_packed = list(tstacked)
    for i, g in tcodec.unpack(decs, tpp).items():
        got_packed[i] = g
    small = [None if pl.coded else f for f, pl in zip(tstacked, tflat_plans)]
    for i, g in tc.psum_fallback(small, tflat_plans, comm).items():
        got_packed[i] = g
    got_leaf = [tcodec.decode_leaf(f, Wt, pl, comm) if pl.coded
                else comm.psum(f) for f, pl in zip(tstacked, tflat_plans)]
    return want, got_packed, got_leaf, counts, len(tpp.buckets)


# [(8,)] and [(8,), (16,)] give the a2a schedule one-element chunks: the
# reference's own packed and per-leaf decodes differ there by 1 ulp (XLA's
# CPU einsum rounds an (n, 1) and an (n, 32) contraction differently); the
# port's stay bitwise equal
@pytest.mark.parametrize("shapes", [MIXED_SHAPES, [(8,)], [(8,), (16,)]],
                         ids=["mixed", "8", "8-16"])
@pytest.mark.parametrize("schedule", ["gather", "a2a"])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_decode_matches_reference_and_packed_is_bitwise_per_leaf(schedule,
                                                                 wire, shapes):
    want, got_packed, got_leaf, counts, nb = _decode_both(
        shapes, schedule, wire)
    # the a2a second hop rounds the decoded slices to a bf16 wire
    tol = F32_TOL if wire == "float32" or schedule == "gather" \
        else dict(rtol=2e-2, atol=2e-2)
    for w, gp, gl in zip(want, got_packed, got_leaf):
        assert tuple(gp.shape) == tuple(w.shape) and gp.dtype == torch.float32
        np.testing.assert_allclose(gp.numpy(), np.asarray(w), **tol)
        assert torch.equal(gp, gl)            # packed == per-leaf, bitwise
    # O(1) collectives per bucket: one hop for gather, two for a2a
    assert counts["all_gather"] == nb
    assert counts["all_to_all"] == (nb if schedule == "a2a" else 0)
    assert counts["psum"] == 0


# ------------------------------------------------------------------- dispatch
def test_backend_follows_the_explicit_device():
    assert isinstance(tc.resolve_backend("auto", "cpu"), tc.TorchRefBackend)
    assert isinstance(tc.resolve_backend("ref", "cpu"), tc.TorchRefBackend)
    with pytest.raises(ValueError):
        tc.resolve_backend("hopper", "cpu")
    with pytest.raises(ValueError):
        tc.resolve_backend("pallas", "cpu")
    with pytest.raises(ValueError):
        tc.get_schedule("ring")
    be = tc.TorchRefBackend()
    assert tc.resolve_backend(be, "cpu") is be
    if not torch.cuda.is_available():
        # never a quiet CPU: a cuda device that does not exist is an error
        for name in ("auto", "hopper", "ref"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tc.resolve_backend(name, "cuda")


def test_codec_built_directly_keeps_its_device():
    """A ``Codec`` built without ``make_codec`` puts its accumulators and
    wire rows on the device it was given; without one it resolves the card,
    never a quiet host."""
    code = tcore.make_code(4, 3, 1, 2)
    kw = dict(code=code, schedule=tc.get_schedule("gather"),
              backend=tc.TorchRefBackend())
    codec = tc.Codec(**kw, device="cpu")
    assert codec.device == torch.device("cpu")
    tree = {"w": torch.zeros(8, 6)}
    plans = codec.plan(tree)
    pplan = codec.pack_plan(tree, plans)
    bufs = (codec.bucket_acc_zeros(pplan) + codec.wire_rows(pplan)
            + [codec.encoding_zero(tree["w"], plans["w"])])
    assert all(b.device.type == "cpu" for b in bufs)
    if torch.cuda.is_available():
        assert tc.Codec(**kw).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.Codec(**kw)


def test_scheme_spec_levers():
    spec = tc.SchemeSpec(schedule="a2a", encode_dtype="bfloat16")
    assert spec.replace(packed=False).packed is False
    assert spec.uses_encoding and not tc.SchemeSpec(schedule="psum").uses_encoding
    codec = spec.make_codec(TCODE, device="cpu")
    assert codec.wire_dtype == torch.bfloat16 and codec.schedule.name == "a2a"
    assert tc.SchemeSpec(pipelined=True, fuse_apply=True).pipelined
    # the reference's eager validation of the pipelined levers
    for kw, msg in ((dict(pipelined=True, packed=False), "packed"),
                    (dict(pipelined=True, partial=True), "partial"),
                    (dict(pipelined=True, schedule="psum"), "encoding"),
                    (dict(fuse_apply=True), "pipelined")):
        with pytest.raises(ValueError, match=msg):
            tc.SchemeSpec(**kw)
    with pytest.raises(ValueError):
        tc.SchemeSpec(encode_dtype="int8")
    # the fused codec phases: a fold into a bucket slot equals the per-leaf
    # encode laid into the slot, and the fused decode-apply equals decode +
    # the update expressions
    tree = {"a": torch.empty(6, 8, 5), "b": torch.empty(64)}
    plans = codec.plan(tree)
    pplan = codec.pack_plan(tree, plans)
    (buf,) = codec.bucket_acc_zeros(pplan)
    g = torch.randn(6, 8, 5, generator=torch.Generator().manual_seed(0))
    coef = torch.tensor([0.5, -2.0])
    slot = pplan.buckets[0].slots[0]
    assert codec.encode_into(buf, g, coef, slot) is buf
    enc = codec.encode_leaf(g, coef, plans["a"]).reshape(-1)
    assert torch.equal(buf[slot.offset:slot.offset + slot.size], enc)
    assert torch.count_nonzero(buf[slot.offset + slot.size:]) == 0
    bufs = torch.stack([buf * (i + 1) for i in range(N)])
    W = torch.ones(N, M)
    P = torch.ones(buf.shape[0], M)
    MU = torch.zeros(buf.shape[0], M)
    pn, mun, ss = codec.decode_apply_packed(bufs, W, P, MU,
                                            make_local_comm(N, "cpu"),
                                            lr=0.1, momentum=0.9, scale=0.5)
    g_dec = codec.decode_packed(bufs, W, make_local_comm(N, "cpu")) * 0.5
    assert torch.equal(mun, g_dec) and torch.equal(pn, 1 - 0.1 * g_dec)
    assert torch.equal(ss, torch.sum(g_dec * g_dec))


def test_comm_collectives():
    comm = make_local_comm(4, "cpu")
    x = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8)
    assert torch.equal(comm.all_gather(x), x)
    ex = comm.all_to_all(x)                   # [p, q] = chunk p of worker q
    assert ex.shape == (4, 4, 2) and ex.is_contiguous()
    assert torch.equal(ex[1, 3], x[3, 2:4])
    assert torch.equal(comm.psum(x), x.sum(0))
    assert comm.counts == {"all_gather": 1, "all_to_all": 1, "psum": 1}
    with pytest.raises(ValueError):
        comm.all_gather(torch.zeros(3, 8))
    with pytest.raises(ValueError):
        comm.all_to_all(torch.zeros(4, 6))
    comm.reset_counts()
    assert sum(comm.counts.values()) == 0
