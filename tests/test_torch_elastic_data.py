"""The port's elastic data pipeline (dlrover_tpu_torch/trainer/elastic/
data.py) against the JAX package's, on the same inputs.

- `ElasticDistributedSampler`: index sequences equal over a sweep of
  dataset size, world, rank, shuffle, seed, epoch and drop_last
  (`np.random.RandomState(seed + epoch)` in both), and a `state_dict`
  taken mid-epoch loaded onto another world.
- `ElasticDataLoader`: batches equal, and a batch-size change taken
  from the master's `ParallelConfig`, set on both servicers.
- `ShardingClient.iter_shards`, `IndexShardingClient.fetch_index` and
  `ElasticDataset.batches`, each against its package's LocalJobMaster.
- `elastic_batch_plan` equal over a sweep.
Everything compared is integers or host numpy arrays: exact equality.
"""

import contextlib
import itertools
import random

import numpy as np
import pytest

from dlrover_tpu.agent.master_client import MasterClient as JClient
from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.master.master import LocalJobMaster as JMaster
from dlrover_tpu.trainer.elastic import data as jdata
from dlrover_tpu_torch.agent.master_client import MasterClient as TClient
from dlrover_tpu_torch.common import messages as tmsg
from dlrover_tpu_torch.master.master import LocalJobMaster as TMaster
from dlrover_tpu_torch.trainer.elastic import data as tdata

SIDES = ((jdata, JMaster, JClient, jmsg), (tdata, TMaster, TClient, tmsg))


def both(scenario, *args):
    return tuple(scenario(*side, *args) for side in SIDES)


@contextlib.contextmanager
def _client(Master, Client):
    m = Master(num_nodes=1, poll_interval=0.05)
    m.start()
    c = Client(m.addr, node_id=0)
    try:
        yield m, c
    finally:
        c.close()
        m.stop()


# ---- the sampler -------------------------------------------------------------

SWEEP = [
    # (dataset size, world, shuffle, seed, epoch, drop_last); every rank
    (1, 1, False, 0, 0, True),
    (7, 3, False, 0, 0, True),
    (7, 3, False, 0, 0, False),
    (64, 4, True, 0, 0, True),
    (64, 4, True, 0, 3, True),
    (103, 4, True, 5, 1, False),
    (103, 8, True, 5, 2, True),
    (100, 3, True, 17, 0, False),
    (33, 5, False, 2, 4, False),
    (250, 6, True, 123, 7, True),
]


def _sampler_run(data, Master, Client, msg, n, world, shuffle, seed, epoch,
                 drop_last):
    out = []
    for rank in range(world):
        s = data.ElasticDistributedSampler(n, world, rank, shuffle=shuffle,
                                           seed=seed, drop_last=drop_last)
        s.set_epoch(epoch)
        out.append((list(s), len(s)))
    return out


@pytest.mark.parametrize("case", SWEEP, ids=[str(c) for c in SWEEP])
def test_sampler_indices_equal_jax(case):
    j, t = both(_sampler_run, *case)
    assert t == j
    n, world, _, _, _, drop_last = case
    seen = [i for idx, _ in t for i in idx]
    assert len(set(seen)) == len(seen)
    assert len(seen) == (n - n % world if drop_last else n)
    assert all(len(idx) == ln for idx, ln in t)


RESHARD = [
    # (size, old world, consumed batches per replica, batch, new world,
    #  shuffle, drop_last)
    (60, 2, 10, 1, 4, False, True),
    (64, 4, 3, 2, 2, True, True),
    (103, 3, 5, 2, 5, True, False),
    (200, 8, 2, 4, 3, True, True),
]


def _reshard(data, Master, Client, msg, n, world, batches, bsz, new_world,
             shuffle, drop_last):
    s = data.ElasticDistributedSampler(n, world, 0, shuffle=shuffle, seed=9,
                                       drop_last=drop_last)
    s.set_epoch(1)
    for _ in range(batches):
        s.record_batch(bsz)
    state = s.state_dict()
    out = [state]
    for rank in range(new_world):
        r = data.ElasticDistributedSampler(n, world, 0, shuffle=shuffle,
                                           seed=9, drop_last=drop_last)
        r.load_state_dict(state, num_replicas=new_world, rank=rank)
        out.append((r.state_dict(), list(r), len(r)))
    with pytest.raises(ValueError):
        data.ElasticDistributedSampler(n, world, 0).load_state_dict(
            state, num_replicas=1, rank=1)
    return out


@pytest.mark.parametrize("case", RESHARD, ids=[str(c) for c in RESHARD])
def test_sampler_state_dict_onto_a_new_world_equal_jax(case):
    j, t = both(_reshard, *case)
    assert t == j
    n, world, batches, bsz, new_world, shuffle, _ = case
    consumed = world * batches * bsz
    assert t[0] == {"epoch": 1, "completed_num": consumed}
    rest = sorted(i for _, idx, _ in t[1:] for i in idx)
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(9 + 1).shuffle(order)
    assert set(rest) <= set(order[consumed:].tolist())


# ---- the loader ---------------------------------------------------------------


def _rows(n=23, width=5):
    return [{"tokens": np.arange(i * width, (i + 1) * width),
             "label": np.int64(i)} for i in range(n)]


def _batches(batches):
    return [{k: v.tolist() for k, v in b.items()} for b in batches]


def _loader(data, Master, Client, msg, shuffle, drop_last):
    rows = _rows()
    out = []
    for world, rank in ((1, 0), (2, 1)):
        sampler = data.ElasticDistributedSampler(
            len(rows), world, rank, shuffle=shuffle, seed=4,
            drop_last=drop_last)
        loader = data.ElasticDataLoader(rows, 4, sampler=sampler,
                                        drop_last=drop_last)
        out.append((_batches(loader), sampler.state_dict()))
    plain = data.ElasticDataLoader(list(range(10)), 3)
    out.append([b.tolist() for b in plain])
    return out


@pytest.mark.parametrize("shuffle,drop_last", list(itertools.product(
    (False, True), (False, True))))
def test_loader_batches_equal_jax(shuffle, drop_last):
    j, t = both(_loader, shuffle, drop_last)
    assert t == j
    assert t[2] == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]


def _loader_config(data, Master, Client, msg):
    """The batch size follows the master's ParallelConfig: adopted at
    the next epoch's start (poll_config in __iter__), and only when its
    version is newer."""
    rows = _rows(30)
    with _client(Master, Client) as (m, c):
        sampler = data.ElasticDistributedSampler(len(rows), 1, 0,
                                                 shuffle=False)
        loader = data.ElasticDataLoader(rows, 4, sampler=sampler,
                                        master_client=c)
        first = _batches(loader)
        m.servicer.paral_config = msg.ParallelConfig(
            dataloader_batch_size=6, version=1)
        sampler.set_epoch(1)
        second = _batches(loader)
        m.servicer.paral_config = msg.ParallelConfig(
            dataloader_batch_size=2, version=1)     # not newer: ignored
        sampler.set_epoch(2)
        third = _batches(loader)
        return first, second, third, loader.batch_size


def test_loader_batch_size_from_the_master_equal_jax():
    j, t = both(_loader_config)
    assert t == j
    first, second, third, size = t
    assert [len(b["label"]) for b in first] == [4] * 7
    assert [len(b["label"]) for b in second] == [6] * 5
    assert third == second and size == 6


# ---- the sharding clients and the dataset ------------------------------------


def _sharding(data, Master, Client, msg, shuffle):
    with _client(Master, Client) as (m, c):
        random.seed(21)
        sc = data.ShardingClient("shards", 37, 5, master_client=c,
                                 num_epochs=2, shuffle=shuffle)
        shards = [(t.task_id, t.shard_start, t.shard_end, t.epoch)
                  for t in sc.iter_shards()]
        random.seed(22)
        ic = data.IndexShardingClient("index", 13, 4, master_client=c,
                                      shuffle=shuffle, storage_type="table")
        indices = []
        while True:
            i = ic.fetch_index()
            if i is None:
                break
            indices.append(i)
        done = [m.servicer.task_manager.get_dataset(n).finished()
                for n in ("shards", "index")]
        return shards, indices, done


@pytest.mark.parametrize("shuffle", [False, True])
def test_sharding_clients_equal_jax(shuffle):
    j, t = both(_sharding, shuffle)
    assert t == j
    shards, indices, done = t
    assert len(shards) == 16 and done == [True, True]
    assert sorted(indices) == list(range(13))


def _dataset(data, Master, Client, msg, shuffle, drop_last):
    tokens = np.random.default_rng(3).integers(0, 100, size=(22, 9))
    with _client(Master, Client) as (m, c):
        random.seed(5)
        ds = data.ElasticDataset(
            "rows", len(tokens), 4,
            lambda i: {"tokens": tokens[i], "index": np.int64(i)},
            master_client=c, shuffle=shuffle)
        batches = _batches(ds.batches(4, drop_last=drop_last))
        return (batches, len(ds),
                m.servicer.task_manager.get_dataset("rows").finished())


@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, True),
                                               (True, False)])
def test_elastic_dataset_batches_equal_jax(shuffle, drop_last):
    j, t = both(_dataset, shuffle, drop_last)
    assert t == j
    batches, size, finished = t
    idx = [i for b in batches for i in b["index"]]
    assert size == 22 and finished
    assert sorted(idx) == list(range(20 if drop_last else 22))


@pytest.mark.parametrize("global_batch,world,max_per", [
    (8, 1, 8), (8, 2, 2), (32, 4, 3), (12, 3, 1), (64, 8, 5)])
def test_elastic_batch_plan_equal_jax(global_batch, world, max_per):
    assert (tdata.elastic_batch_plan(global_batch, world, max_per)
            == jdata.elastic_batch_plan(global_batch, world, max_per))
    with pytest.raises(ValueError):
        tdata.elastic_batch_plan(global_batch + 1, 2, max_per)
