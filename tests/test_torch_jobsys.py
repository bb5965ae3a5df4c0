"""The port's JobSystem (chord_tpu_torch/native, over the shared
native/jobsys.cpp): every case of chord_tpu's tests/test_jobsys.py
(dependency chains, fan-out under parent counters, parallel-for oracles),
run on the port's binding, and the process-global pool's identity."""

import threading
import time

import numpy as np
import pytest

from chord_tpu_torch.native import JobSystem, available, job_system

pytestmark = pytest.mark.skipif(not available(),
                                reason="native toolchain unavailable")


def test_workers_positive():
    js = job_system()
    assert js.workers >= 1


def test_single_job_runs():
    js = job_system()
    hits = []
    j = js.launch(lambda: hits.append(1))
    js.wait(j)
    assert hits == [1]


def test_dependency_chain_order():
    """A -> B -> C strict ordering (reference sequential chains)."""
    js = job_system()
    order = []
    lock = threading.Lock()

    def mk(tag):
        def run():
            with lock:
                order.append(tag)
        return run

    a = js.launch(mk("a"))
    b = js.launch(mk("b"), deps=(a,))
    c = js.launch(mk("c"), deps=(b,))
    js.wait(c)
    assert order == ["a", "b", "c"]


def test_fan_in_dependencies():
    """N independent jobs -> one join job that sees all results."""
    js = job_system()
    n = 32
    results = np.zeros(n, np.int64)

    def mk(i):
        def run():
            results[i] = i * i
        return run

    deps = tuple(js.launch(mk(i)) for i in range(n))
    total = []
    j = js.launch(lambda: total.append(int(results.sum())), deps=deps)
    js.wait(j)
    assert total == [sum(i * i for i in range(n))]


def test_parent_child_counters():
    """Waiting on the parent also waits for children the parent's body
    launched under itself (reference job_system.h parent counters)."""
    js = job_system()
    hits = []
    lock = threading.Lock()
    p = []
    handle_known = threading.Event()   # body needs its own handle

    def body():
        assert handle_known.wait(timeout=10)
        for k in range(8):
            def child(k=k):
                time.sleep(0.002)
                with lock:
                    hits.append(k)
            js.launch_child(p[0], child)

    p.append(js.launch(body))
    handle_known.set()
    js.wait(p[0])
    assert sorted(hits) == list(range(8))


def test_dependent_on_finished_job_runs_immediately():
    js = job_system()
    a = js.launch(lambda: None)
    js.wait(a)
    hits = []
    b = js.launch(lambda: hits.append(1), deps=(a,))
    js.wait(b)
    assert hits == [1]


def test_parallel_for_sum_oracle():
    """Randomized payload sum vs serial oracle (the reference's MPMC
    producer/consumer sum test shape)."""
    js = job_system()
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 1000, size=2048)
    out = np.zeros(2048, np.int64)
    js.parallel_for(2048, lambda i: out.__setitem__(i, payload[i] * 2))
    assert out.sum() == payload.sum() * 2


def test_parallel_for_grain_covers_every_index_once():
    js = job_system()
    n, grain = 1000, 64
    counts = np.zeros(n, np.int32)
    lock = threading.Lock()

    def body(s, e):
        with lock:
            counts[s:e] += 1

    js.parallel_for_grain(n, grain, body)
    assert (counts == 1).all()


def test_callback_exception_propagates():
    js = job_system()

    def boom(i):
        if i == 7:
            raise ValueError("boom")

    with pytest.raises(ValueError):
        js.parallel_for(16, boom)


def test_many_jobs_stress():
    """Enough jobs to force stealing + the global overflow queue."""
    js = job_system()
    n = 500
    counter = np.zeros(1, np.int64)
    lock = threading.Lock()

    def bump():
        with lock:
            counter[0] += 1

    jobs = [js.launch(bump) for _ in range(n)]
    for j in jobs:
        js.wait(j)
    assert counter[0] == n


def test_job_system_is_process_global():
    js = job_system()
    assert js is job_system() and isinstance(js, JobSystem)


def test_exception_in_launched_job_reraised_by_wait_then_cleared():
    js = job_system()

    def boom():
        raise KeyError("job")

    j = js.launch(boom)
    with pytest.raises(KeyError):
        js.wait(j)
    ok = js.launch(lambda: None)
    js.wait(ok)          # the error was handed over once
    assert js.finished(ok)


def test_drain_waits_for_every_job():
    js = job_system()
    hits = []
    lock = threading.Lock()

    def slow(k):
        def run():
            time.sleep(0.001)
            with lock:
                hits.append(k)
        return run

    for k in range(20):
        js.launch(slow(k))
    js.drain()
    assert sorted(hits) == list(range(20))
