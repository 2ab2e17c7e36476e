"""The port's policy and experience queues (``repro_torch.core.queues``):
the ``PolicyStore`` snapshot rule, latest-wins and thread safety, and the
``ExperienceQueue`` staleness and drop accounting, as
``tests/test_core_queues.py`` holds the reference's."""
import sys
import threading

import pytest
import torch

from repro_torch.core.queues import (
    Experience,
    ExperienceQueue,
    PolicyStore,
    snapshot,
)
from repro_torch.models import mlp_policy


def _policy():
    return mlp_policy.init_policy(torch.Generator().manual_seed(0), 3, 1,
                                  hidden=8)


def test_policy_store_latest_wins():
    store = PolicyStore({"w": 0})
    assert store.read() == ({"w": 0}, 0)
    for i in range(1, 5):
        store.publish({"w": i})
    params, version = store.read()
    assert params == {"w": 4} and version == 4


def test_publish_stores_a_snapshot_that_in_place_updates_leave_alone():
    """The port's learners update parameters in place; what ``read``
    returns must be what was published, whatever the learner does after."""
    policy = _policy()
    store = PolicyStore(policy)
    store.publish(policy)
    published = [p.detach().clone() for p in policy.parameters()]
    with torch.no_grad():
        for p in policy.parameters():
            p.add_(1.0)                      # the learner's next update
    got, version = store.read()
    assert version == 1 and got is not policy
    for a, b in zip(got.parameters(), published):
        assert torch.equal(a, b) and not a.requires_grad
    # the snapshot acts: a sampler thread can run the policy on it
    action, logp = got.sample_action(torch.zeros(2, 3), torch.zeros(2, 1))
    assert action.shape == (2, 1) and logp.shape == (2,)


def test_snapshot_detaches_tensors_in_containers():
    w = torch.ones(3, requires_grad=True)
    out = snapshot({"w": w, "n": 5, "pair": (w, w)})
    assert out["n"] == 5 and not out["w"].requires_grad
    with torch.no_grad():
        w.add_(1.0)
    assert torch.equal(out["w"], torch.ones(3))
    assert isinstance(out["pair"], tuple)


def test_policy_store_thread_safety():
    """More threads than cores and a short switch interval: 800 publishes
    count 800 versions (a lost update would show fewer)."""
    store = PolicyStore(torch.zeros(4))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def writer():
            for _ in range(200):
                store.publish(store.read()[0])

        threads = [threading.Thread(target=writer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert store.version == 800 and store.publish_count == 800


def test_experience_queue_staleness_accounting():
    q = ExperienceQueue()
    q.put(Experience(traj={}, policy_version=3, sampler_id=0,
                     collect_seconds=0.1))
    q.put(Experience(traj={}, policy_version=5, sampler_id=1,
                     collect_seconds=0.1))
    q.get(learner_version=5)
    q.get(learner_version=6)
    assert q.staleness == [2, 1]
    assert q.mean_staleness() == pytest.approx(1.5)


def test_experience_queue_drain_bounded():
    q = ExperienceQueue()
    for i in range(5):
        q.put(Experience({}, i, 0, 0.0))
    items = q.drain(learner_version=10, max_items=3)
    assert len(items) == 3 and q.qsize() == 2


def test_experience_queue_counts_overflow_drops():
    q = ExperienceQueue(maxsize=1)
    assert q.put(Experience({}, 0, 0, 0.0), timeout=0.01)
    assert not q.put(Experience({}, 1, 0, 0.0), timeout=0.01)
    assert not q.put(Experience({}, 2, 0, 0.0), timeout=0.01)
    assert q.drop_count == 2 and q.put_count == 1
    q.get(learner_version=0)
    assert q.put(Experience({}, 3, 0, 0.0), timeout=0.01)
    assert q.drop_count == 2 and q.put_count == 2
