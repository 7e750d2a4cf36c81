"""Host pipeline: input read-ahead, align workers, ordered output writer.

Counterpart of omp_bowtie2_prime_tpu/models/pipeline.py, name for name.
The analog of the reference's dedicated parser thread and ready queue
(PatternSourceReadAheadFactory, pat.h:1283-1402) and its input-order
OutputQueue writer (outq.h:31-160). Three stages overlap: a reader thread
parses batches ahead, the align worker(s) drive the device, and a writer
thread formats and writes the records in input order. Waits on the
device (event waits, copies) and torch's operators release the GIL, so
parsing and writing run while a worker waits.

With two align workers (``align_fns`` of two callables, each over its own
``TorchAligner``, so that no per-batch state is shared), one batch's host
phases (framing, candidate collection, the finish) run while the other's
device work runs on the other instance's CUDA stream. The Python of both
workers still takes turns on the GIL. Output stays in input order:
batches carry a sequence number and the writer puts them back in order.
"""

from __future__ import annotations

import contextlib
import heapq
import queue
import threading

_DONE = object()


def align_stream(als, batches, emit_fn=None):
    """One thread, batches pipelined across two instances: batch k+1's
    matrices are built and its round 0 is queued on its instance's stream
    from inside batch k's ``align_batch``, so that the device runs the
    next batch's seed search while the host frames, collects and finishes
    this one, with no second thread to share the GIL with.

    als: two or more TorchAligner instances over the same index (share=);
    batches: the read batches; emit_fn(k, results), optional, is called
    in input order. Returns the per-batch results."""
    nals = len(als)
    assert nals >= 2, "align_stream needs two aligner instances"
    batches = list(batches)
    nb = len(batches)
    results = [None] * nb
    state = [None] * nb  # k -> (aligner, minscs, round 0 handle)

    def _build(k):
        a = als[k % nals]
        with a.timers.phase("buildMatrices"):
            a.build_read_matrices(batches[k])
        minscs = a.min_scores(batches[k])
        state[k] = (a, minscs, None)

    def _mega(k):
        a, minscs, _ = state[k]
        state[k] = (a, minscs, a.dispatch_round0(batches[k], minscs))

    if nb:
        _build(0)
        _mega(0)
    for k in range(nb):
        a, minscs, h = state[k]
        state[k] = None
        # batch k's align_batch calls the build of batch k+1 once its main
        # DP is queued (host work while that runs) and the dispatch of
        # batch k+1's round 0 once its wide escalation is queued, so that
        # the device holds [wide(k), round 0 (k+1)] under batch k's host
        # tail
        cb = ((lambda kk=k + 1: _build(kk)),
              (lambda kk=k + 1: _mega(kk))) if k + 1 < nb else None
        results[k] = a.align_batch(
            batches[k], _prebuilt=True, _predisp=h, _minscs=minscs,
            _next_cb=cb,
        )
        if emit_fn is not None:
            emit_fn(k, results[k])
    return results


class BatchTurns:
    """The order in which one stream's numbered batches may make their
    collectives: batch k's, once the call of every batch before it has
    returned. ``run_pipeline`` opens one for its workers when it has two
    or more; an aligner on a mesh waits for its batch's turn
    (``wait_turn``) before it takes the placer's lock, and an aligner
    without one never waits. Every rank runs the same stream, so the
    ranks' collectives meet batch for batch whichever of a rank's workers
    holds which batch; the placer's lock alone keeps only one rank's
    batches apart. The JAX package's pipeline has no such order because
    it needs none: its mesh is one process."""

    _local = threading.local()

    def __init__(self, stopped):
        self.cv = threading.Condition()
        self.next = 0  # the first batch whose call has not returned
        self.ended: set = set()  # later batches whose call has returned
        self.stopped = stopped  # () -> True once the stream is abandoned

    @contextlib.contextmanager
    def batch(self, seq: int):
        """The body runs as batch ``seq`` of the stream."""
        BatchTurns._local.cur = (self, seq)
        try:
            yield
        finally:
            BatchTurns._local.cur = None
            with self.cv:
                self.ended.add(seq)
                while self.next in self.ended:
                    self.ended.discard(self.next)
                    self.next += 1
                self.cv.notify_all()

    def wait(self, seq: int) -> None:
        """Blocks until batch ``seq``'s turn; raises once the stream is
        abandoned (a stage of the pipeline failed)."""
        with self.cv:
            while self.next != seq:
                if self.stopped():
                    raise RuntimeError("the batch stream stopped")
                self.cv.wait(timeout=0.2)


def wait_turn() -> None:
    """Blocks until the calling thread's batch (``BatchTurns.batch``) may
    make its collectives; returns at once outside a stream's batch."""
    cur = getattr(BatchTurns._local, "cur", None)
    if cur is not None:
        cur[0].wait(cur[1])


def run_pipeline(batches, align_fn, emit_fn, depth: int = 2,
                 align_fns=None):
    """batches: iterator of input batches; align_fn(batch) -> results;
    emit_fn(batch, results) -> None (called in input order). Returns the
    count of items aligned. An error of the reader, a worker or the writer
    stops every stage and is raised here.

    align_fns: optional list of align callables, one per align worker
    (each must own its per-batch state); align_fn is ignored when given.
    A single worker runs in the calling thread.

    Two or more workers run each batch as a turn of one ``BatchTurns``:
    aligners that share a mesh placer make their batches' collectives in
    input order, on every rank alike.
    """
    fns = list(align_fns) if align_fns else [align_fn]
    in_q: queue.Queue = queue.Queue(maxsize=depth)
    out_q: queue.Queue = queue.Queue(maxsize=depth + len(fns))
    errs: list = []
    turns = BatchTurns(lambda: bool(errs)) if len(fns) > 1 else None

    def put_checked(q, item):
        # bounded put that never deadlocks on a dead consumer: bail as
        # soon as any stage recorded an error
        while not errs:
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for seq, b in enumerate(batches):
                if not put_checked(in_q, (seq, b)):
                    break
        except BaseException as e:  # raised in the caller
            errs.append(e)
        finally:
            for _ in fns:
                put_checked(in_q, _DONE)

    def writer():
        next_seq = 0
        held: list = []  # (seq, batch, results) min-heap
        done_workers = 0
        while not errs:
            try:
                item = out_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is _DONE:
                done_workers += 1
                if done_workers == len(fns):
                    return
                continue
            heapq.heappush(held, item)
            try:
                while held and held[0][0] == next_seq:
                    _, b, results = heapq.heappop(held)
                    emit_fn(b, results)
                    next_seq += 1
            except BaseException as e:
                errs.append(e)
                return

    def align_worker(fn):
        try:
            while not errs:
                try:
                    item = in_q.get(timeout=0.2)
                except queue.Empty:
                    continue
                if item is _DONE:
                    return
                seq, b = item
                if turns is None:
                    results = fn(b)
                else:
                    with turns.batch(seq):
                        results = fn(b)
                if not put_checked(out_q, (seq, b, results)):
                    return
                counts.append(len(b))
        except BaseException as e:
            errs.append(e)
        finally:
            put_checked(out_q, _DONE)

    counts: list = []
    pt = threading.Thread(target=producer, daemon=True)
    wt = threading.Thread(target=writer, daemon=True)
    pt.start()
    wt.start()
    if len(fns) == 1:
        # single worker runs inline (no extra thread hop on the hot path)
        align_worker(fns[0])
    else:
        ats = [threading.Thread(target=align_worker, args=(fn,),
                                daemon=True)
               for fn in fns]
        for t in ats:
            t.start()
        for t in ats:
            t.join()
    wt.join()
    pt.join()  # no stage touches the input or output after the return
    if errs:
        raise errs[0]
    return sum(counts)
