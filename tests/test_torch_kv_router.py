"""The port's KV router (radix tree, active sequences, worker selection, the
admission queue, the worker's local indexer, TinyLFU and the wire dicts)
against the JAX package's Python classes on the same seeded inputs.

Every comparison is exact: hashes, ids, scores and block counts are
integers, and selection logits are the same Python floats. The reference's
RadixTree is constructed directly (never its native C++ tree). Random event
streams are drawn from numpy seeds and mix stored chains that extend one
another, removals, clears, skipped ids (gaps) and repeated ids (stale)."""

import asyncio
import random
import time

import numpy as np
import pytest

from dynamo_tpu.block_manager.tinylfu import TinyLfu as RefLfu
from dynamo_tpu.kv_router import protocols as ref_proto
from dynamo_tpu.kv_router import queue as ref_queue
from dynamo_tpu.kv_router import scheduler as ref_sched
from dynamo_tpu.kv_router.indexer import RadixTree as RefTree
from dynamo_tpu.kv_router.local_indexer import LocalKvIndexer as RefLocal
from dynamo_tpu.kv_router.sequences import ActiveSequences as RefSeqs
from dynamo_tpu_torch.kv_router import make_radix_tree, protocols
from dynamo_tpu_torch.kv_router import queue as port_queue
from dynamo_tpu_torch.kv_router import scheduler as port_sched
from dynamo_tpu_torch.kv_router.indexer import RadixTree
from dynamo_tpu_torch.kv_router.local_indexer import LocalKvIndexer
from dynamo_tpu_torch.kv_router.sequences import ActiveSequences
from dynamo_tpu_torch.kv_router.tinylfu import TinyLfu

WORKERS = (0x1A, 0x2B, 0x3C)


def _stream(seed: int, n: int = 300, hashes: int = 120):
    """(RouterEvent wire dicts, the hash pool): per worker, stored chains
    that extend a block the worker (or another) stored, removals of stored
    blocks, rare clears; about 4% of events skip an id and 4% repeat an old
    one."""
    rng = np.random.default_rng(seed)
    pool = [int(h) for h in rng.integers(1, 2**63, hashes, dtype=np.uint64)]
    next_id = {w: 0 for w in WORKERS}
    held = {w: [] for w in WORKERS}
    out = []
    for _ in range(n):
        w = WORKERS[int(rng.integers(len(WORKERS)))]
        dp = int(rng.integers(2))
        eid = next_id[w]
        roll = rng.random()
        if roll < 0.04:
            eid += 1 + int(rng.integers(3))  # a gap
        elif roll < 0.08 and eid > 0:
            eid = int(rng.integers(eid))  # stale
        next_id[w] = max(next_id[w], eid + 1)
        ev = {"w": w, "e": eid, "d": dp}
        kind = rng.random()
        if kind < 0.6:
            n_blocks = int(rng.integers(1, 6))
            chain = [pool[int(i)] for i in rng.integers(hashes, size=n_blocks)]
            anchor = rng.random()
            parent = (None if anchor < 0.3 or not held[w]
                      else held[w][int(rng.integers(len(held[w])))]
                      if anchor < 0.9 else pool[int(rng.integers(hashes))])
            ev["s"] = {"b": chain, "p": parent}
            held[w] += chain
        elif kind < 0.95 and held[w]:
            k = int(rng.integers(1, min(4, len(held[w])) + 1))
            gone = [held[w][int(i)] for i in rng.integers(len(held[w]),
                                                          size=k)]
            ev["r"] = gone
        else:
            ev["c"] = True
            held[w] = []
        out.append(ev)
    return out, pool


def _scores(scores) -> dict:
    return {(w.worker_id, w.dp_rank): v for w, v in scores.items()}


def _queries(pool, seed: int, n: int = 40) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [[pool[int(i)] for i in rng.integers(len(pool),
                                                size=int(rng.integers(1, 8)))]
            for _ in range(n)]


def _apply_both(events, port_tree, ref_tree):
    statuses = []
    for ev in events:
        statuses.append((
            port_tree.apply_event(protocols.RouterEvent.from_wire(ev)),
            ref_tree.apply_event(ref_proto.RouterEvent.from_wire(ev))))
    return statuses


def _dump(tree, wid, dp):
    return sorted(tree.dump_worker(
        (protocols if isinstance(tree, RadixTree) else ref_proto)
        .WorkerWithDpRank(wid, dp)), key=str)


def _compare(port_tree, ref_tree, queries):
    assert port_tree.total_nodes() == ref_tree.total_nodes()
    assert (_scores(port_tree.worker_block_counts())
            == _scores(ref_tree.worker_block_counts()))
    assert port_tree.gap_count == ref_tree.gap_count
    for w in WORKERS:
        for dp in range(2):
            assert _dump(port_tree, w, dp) == _dump(ref_tree, w, dp)
    for q in queries:
        mine, theirs = port_tree.find_matches(q), ref_tree.find_matches(q)
        assert _scores(mine.scores) == _scores(theirs.scores)
        assert _scores(mine.tree_sizes) == _scores(theirs.tree_sizes)
        early = port_tree.find_matches(q, early_exit=True)
        assert (_scores(early.scores)
                == _scores(ref_tree.find_matches(q, early_exit=True).scores))


@pytest.mark.parametrize("seed", range(6))
def test_random_event_streams_match_the_reference(seed):
    events, pool = _stream(seed)
    port_tree, ref_tree = RadixTree(), RefTree()
    statuses = _apply_both(events, port_tree, ref_tree)
    assert [a for a, _ in statuses] == [b for _, b in statuses]
    assert {"ok", "gap", "stale"} <= {a for a, _ in statuses}
    assert port_tree.total_nodes() > 0
    _compare(port_tree, ref_tree, _queries(pool, seed + 100))


@pytest.mark.parametrize("seed", range(3))
def test_dump_load_and_remove_worker_match_the_reference(seed):
    events, pool = _stream(seed + 10)
    port_tree, ref_tree = RadixTree(), RefTree()
    _apply_both(events, port_tree, ref_tree)
    queries = _queries(pool, seed)
    # a resync: reload worker 0's dp 0 view from its own dump, reversed
    # (children before parents), and worker 1's from worker 2's blocks
    for tree, proto in ((port_tree, protocols), (ref_tree, ref_proto)):
        w0 = proto.WorkerWithDpRank(WORKERS[0], 0)
        tree.load_worker(w0, list(reversed(tree.dump_worker(w0))),
                         last_event_id=1000)
        donor = tree.dump_worker(proto.WorkerWithDpRank(WORKERS[2], 1))
        tree.load_worker(proto.WorkerWithDpRank(WORKERS[1], 0), donor)
    _compare(port_tree, ref_tree, queries)
    # the reloaded worker's next event is stale below 1000, a gap above
    for tree, proto in ((port_tree, protocols), (ref_tree, ref_proto)):
        assert tree.apply_event(proto.RouterEvent(WORKERS[0], 999)) == "stale"
        assert tree.apply_event(proto.RouterEvent(WORKERS[0], 1002)) == "gap"
        tree.remove_worker_id(WORKERS[2])
    _compare(port_tree, ref_tree, queries)
    assert _dump(port_tree, WORKERS[2], 1) == []


def test_ttl_expiry_through_maintain_matches_the_reference(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    events, pool = _stream(21)
    port_tree, ref_tree = RadixTree(ttl_secs=5.0), RefTree(ttl_secs=5.0)
    evicted = []
    for i in range(0, len(events), 30):
        _apply_both(events[i:i + 30], port_tree, ref_tree)
        clock[0] += 1.5
        evicted.append((port_tree.maintain(), ref_tree.maintain()))
        evicted.append((port_tree.maintain(clock[0] + 2.0),
                        ref_tree.maintain(clock[0] + 2.0)))
    assert all(a == b for a, b in evicted)
    assert sum(len(a) for a, _ in evicted) > 0
    _compare(port_tree, ref_tree, _queries(pool, 5))


@pytest.mark.parametrize("admission", [False, True])
def test_node_cap_matches_the_reference(monkeypatch, admission):
    """The size budget prunes oldest-first to 80 %; with TinyLFU admission
    a new chain at a full tree enters only if it is asked for more often
    than the oldest entry."""
    clock = [50.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    events, pool = _stream(31, n=400, hashes=200)
    port_tree = RadixTree(max_tree_size=40, admission=admission)
    ref_tree = RefTree(max_tree_size=40, admission=admission)
    queries = _queries(pool, 9, n=60)
    for i in range(0, len(events), 20):
        statuses = _apply_both(events[i:i + 20], port_tree, ref_tree)
        assert [a for a, _ in statuses] == [b for _, b in statuses]
        clock[0] += 0.25
        for q in queries[i // 20::10]:  # query traffic feeds the sketch
            port_tree.find_matches(q)
            ref_tree.find_matches(q)
        assert port_tree.maintain() == ref_tree.maintain()
        assert port_tree.total_nodes() <= 40 + 20 * 5
    assert port_tree.admission_rejected == ref_tree.admission_rejected
    if admission:
        assert port_tree.admission_rejected > 0
    _compare(port_tree, ref_tree, queries)


def test_make_radix_tree_reads_the_reference_knobs(monkeypatch):
    monkeypatch.setenv("DYNT_INDEXER_TTL_SECS", "7.5")
    monkeypatch.setenv("DYNT_INDEXER_MAX_TREE_SIZE", "64")
    monkeypatch.setenv("DYNT_INDEXER_ADMISSION", "1")
    tree = make_radix_tree()
    assert isinstance(tree, RadixTree) and tree.prune_tracking
    assert (tree._ttl, tree._max_tree_size) == (7.5, 64)
    assert tree._lfu is not None
    monkeypatch.setenv("DYNT_INDEXER_MAX_TREE_SIZE", "0")
    assert make_radix_tree()._lfu is None  # admission needs a cap


def test_tinylfu_matches_the_reference():
    rng = np.random.default_rng(3)
    mine, theirs = TinyLfu(64), RefLfu(64)
    keys = [int(k) for k in rng.integers(0, 2**63, 40, dtype=np.uint64)]
    for k in rng.choice(keys, 2000):
        mine.touch(int(k))
        theirs.touch(int(k))
    for a in keys:
        assert mine.estimate(a) == theirs.estimate(a)
        for b in keys[:5]:
            assert mine.admit(a, b) == theirs.admit(a, b)


# -- load prediction, selection, the queue ----------------------------------


def _seq_ops(seed: int, n: int = 200):
    rng = np.random.default_rng(seed)
    live, ops = [], []
    for i in range(n):
        roll = rng.random()
        w = WORKERS[int(rng.integers(3))]
        if roll < 0.45 or not live:
            rid = f"r{i}"
            live.append(rid)
            ops.append(("add", rid, w, int(rng.integers(0, 400)),
                        int(rng.integers(0, 10))))
        elif roll < 0.65:
            ops.append(("prefill", live[int(rng.integers(len(live)))]))
        elif roll < 0.85:
            ops.append(("free", live.pop(int(rng.integers(len(live))))))
        elif roll < 0.97:
            ops.append(("publish", w, int(rng.integers(0, 60)),
                        float(rng.random())))
        else:
            ops.append(("remove", w))
    return ops


def _drive(seqs, proto, ops):
    for op in ops:
        if op[0] == "add":
            seqs.add_request(op[1], proto.WorkerWithDpRank(op[2]), op[3],
                             op[4])
        elif op[0] == "prefill":
            seqs.mark_prefill_completed(op[1])
        elif op[0] == "free":
            seqs.free(op[1])
        elif op[0] == "publish":
            seqs.update_published(proto.LoadMetrics(
                worker_id=op[1], active_blocks=op[2], kv_usage=op[3]))
        else:
            seqs.remove_worker_id(op[1])


@pytest.mark.parametrize("seed", range(3))
def test_active_sequences_match_the_reference(seed):
    ops = _seq_ops(seed)
    mine, theirs = ActiveSequences(16), RefSeqs(16)
    for i in range(0, len(ops), 10):
        _drive(mine, protocols, ops[i:i + 10])
        _drive(theirs, ref_proto, ops[i:i + 10])
        for w in WORKERS:
            pw, rw = protocols.WorkerWithDpRank(w), ref_proto.WorkerWithDpRank(w)
            assert mine.prefill_tokens(pw) == theirs.prefill_tokens(rw)
            assert mine.decode_blocks(pw) == theirs.decode_blocks(rw)
            assert mine.kv_usage(pw) == theirs.kv_usage(rw)
        assert mine.active_request_count() == theirs.active_request_count()


def _schedulers(weight: float, temperature: float):
    port = port_sched.KvScheduler(port_sched.KvRouterConfig(
        overlap_weight=weight, temperature=temperature))
    ref = ref_sched.KvScheduler(ref_sched.KvRouterConfig(
        overlap_weight=weight, temperature=temperature))
    ref.indexer = RefTree()  # the Python tree, as the port's
    return port, ref


@pytest.mark.parametrize("weight,temperature",
                         [(1.0, 0.0), (2.0, 0.0), (1.0, 0.7), (0.5, 1.5)])
def test_selection_matches_the_reference(weight, temperature):
    """The same events, bookings and published load on both schedulers:
    every selection (worker, logit, overlap) is equal, with `random` seeded
    alike for ties and sampling; then the chosen request is booked."""
    port, ref = _schedulers(weight, temperature)
    events, pool = _stream(41, n=200)
    _apply_both(events, port.indexer, ref.indexer)
    rng = np.random.default_rng(43)
    picks = []
    for i, q in enumerate(_queries(pool, 44, n=60)):
        isl = len(q) * 16 + int(rng.integers(0, 16))
        cands = [w for w in WORKERS if rng.random() < 0.8] or [WORKERS[0]]
        dp = int(rng.integers(2))
        seed = int(rng.integers(2**31))
        random.seed(seed)
        mine = port.select_worker(
            [protocols.WorkerWithDpRank(w, dp) for w in cands], q, isl)
        random.seed(seed)
        theirs = ref.select_worker(
            [ref_proto.WorkerWithDpRank(w, dp) for w in cands], q, isl)
        assert ((mine.worker.worker_id, mine.worker.dp_rank), mine.logit,
                mine.overlap_blocks) == (
            (theirs.worker.worker_id, theirs.worker.dp_rank), theirs.logit,
            theirs.overlap_blocks)
        picks.append(mine.worker.worker_id)
        port.add_request(f"q{i}", mine, isl)
        ref.add_request(f"q{i}", theirs, isl)
        if i % 7 == 3:
            port.mark_prefill_completed(f"q{i - 2}")
            ref.mark_prefill_completed(f"q{i - 2}")
        if i % 11 == 5:
            m = int(rng.integers(0, 40))
            port.sequences.update_published(protocols.LoadMetrics(
                worker_id=cands[0], dp_rank=dp, active_blocks=m))
            ref.sequences.update_published(ref_proto.LoadMetrics(
                worker_id=cands[0], dp_rank=dp, active_blocks=m))
    assert len(set(picks)) > 1
    for tree in (port, ref):
        tree.remove_worker_id(WORKERS[1])
    assert port.indexer.total_nodes() == ref.indexer.total_nodes()


def test_softmax_sample_matches_the_reference():
    rng = np.random.default_rng(5)
    for _ in range(50):
        vals = rng.integers(0, 6, 4).astype(float) / 2
        logits = {protocols.WorkerWithDpRank(w): float(v)
                  for w, v in zip(WORKERS + (0x4D,), vals)}
        ref_logits = {ref_proto.WorkerWithDpRank(w.worker_id): v
                      for w, v in logits.items()}
        sizes = {protocols.WorkerWithDpRank(w): int(s)
                 for w, s in zip(WORKERS, rng.integers(0, 3, 3))}
        ref_sizes = {ref_proto.WorkerWithDpRank(w.worker_id): s
                     for w, s in sizes.items()}
        for temp in (0.0, 0.3, 2.0):
            draw = float(rng.random())
            seed = int(rng.integers(2**31))
            random.seed(seed)
            w, v = port_sched.softmax_sample(logits, temp, sizes, draw)
            random.seed(seed)
            rw, rv = ref_sched.softmax_sample(ref_logits, temp, ref_sizes,
                                              draw)
            assert (w.worker_id, v) == (rw.worker_id, rv)


@pytest.mark.parametrize("policy", ["fcfs", "lcfs", "wspt"])
def test_queue_order_matches_the_reference(run, policy):
    """One worker held busy by a booked request; 9 requests of mixed
    lengths, overlaps, classes and priority jumps park; each free drains
    the next one. The drain order is the reference's. The jumps are whole
    minutes, so fcfs / lcfs keys order by (jump, arrival) and not by how
    far apart the host happened to park the requests."""
    events, pool = _stream(51, n=150)

    async def drive(sched_mod, queue_mod, proto, tree_cls):
        sched = sched_mod.KvScheduler(sched_mod.KvRouterConfig())
        sched.indexer = tree_cls()
        for ev in events:
            sched.indexer.apply_event(proto.RouterEvent.from_wire(ev))
        queue = queue_mod.SchedulerQueue(sched, threshold_frac=0.5,
                                         policy=policy,
                                         max_batched_tokens=lambda w: 1000)
        worker = [proto.WorkerWithDpRank(WORKERS[0])]
        sched.add_request("hog", sched.select_worker(worker, [], 900), 900)
        rng = np.random.default_rng(52)
        tasks, order = [], []
        for i, q in enumerate(_queries(pool, 53, n=9)):
            req = queue_mod.QueuedRequest(
                candidates=worker, block_hashes=q,
                isl_tokens=len(q) * 16 + int(rng.integers(0, 200)),
                priority_jump=float(rng.integers(0, 3)) * 60.0,
                request_id=f"r{i}",
                priority_class=("batch", "standard", "interactive")[i % 3])
            task = asyncio.ensure_future(queue.schedule(req))
            task.add_done_callback(lambda t, i=i: order.append(i))
            tasks.append(task)
            await asyncio.sleep(0)
        assert queue.pending_count == 9
        sched.free("hog")
        queue.update()
        for _ in range(9):
            await asyncio.sleep(0)
            await asyncio.sleep(0)
            sched.free(f"r{order[-1]}")
            queue.update()
        await asyncio.gather(*tasks)
        return order

    async def go():
        return (await drive(port_sched, port_queue, protocols, RadixTree),
                await drive(ref_sched, ref_queue, ref_proto, RefTree))

    mine, theirs = run(go())
    assert mine == theirs
    assert sorted(mine) == list(range(9))
    # class-strict: every interactive entry drains before any standard one,
    # every standard one before any batch one
    assert [2 - i % 3 for i in mine] == sorted(2 - i % 3 for i in mine)


# -- the worker's record and the wire ----------------------------------------


def test_local_indexer_matches_the_reference():
    rng = np.random.default_rng(61)
    mine, theirs = LocalKvIndexer(7, 1), RefLocal(7, 1)
    held = []
    for eid in range(300):
        roll = rng.random()
        if roll < 0.6 or not held:
            chain = [int(h) for h in rng.integers(1, 2**63, int(
                rng.integers(1, 5)), dtype=np.uint64)]
            parent = held[int(rng.integers(len(held)))] if held and \
                rng.random() < 0.7 else None
            for idx in (mine, theirs):
                idx.on_stored(eid, chain, parent)
            held += chain
        elif roll < 0.97:
            gone = [held[int(i)] for i in rng.integers(len(held), size=2)]
            for idx in (mine, theirs):
                idx.on_removed(eid, gone)
        else:
            for idx in (mine, theirs):
                idx.on_cleared(eid)
            held = []
        assert mine.dump() == theirs.dump()
    assert mine.block_count() == theirs.block_count() > 0


def test_wire_dicts_match_the_reference():
    events, _ = _stream(71, n=100)
    for ev in events:
        mine = protocols.RouterEvent.from_wire(ev)
        theirs = ref_proto.RouterEvent.from_wire(ev)
        assert mine.to_wire() == theirs.to_wire()
        assert protocols.RouterEvent.from_wire(
            theirs.to_wire()).to_wire() == mine.to_wire()
    metrics = protocols.LoadMetrics(
        worker_id=0x5E, dp_rank=1, active_blocks=12, total_blocks=2048,
        active_requests=3, waiting_requests=1, kv_usage=0.25,
        step_wall_ms=10.5, prefill_tokens_in_step=64,
        decode_tokens_in_step=8)
    wire = metrics.to_wire()
    assert wire == ref_proto.LoadMetrics.from_wire(wire).to_wire()
    assert list(wire) == list(ref_proto.LoadMetrics(worker_id=1).to_wire())
    assert protocols.LoadMetrics.from_wire(
        {**wire, "future_field": 1}) == metrics
    assert (protocols.KV_EVENT_TOPIC, protocols.LOAD_TOPIC,
            protocols.KV_SNAPSHOT_TOPIC) == (
        ref_proto.KV_EVENT_TOPIC, ref_proto.LOAD_TOPIC,
        ref_proto.KV_SNAPSHOT_TOPIC)
    assert protocols.WorkerWithDpRank(3, 1).key() == "3:1"
