"""The port's distributed sampler, process-group set-up and mesh against the JAX package's.

``DistributedGroupSampler`` must give the reference's indices exactly, in
training (each aspect group shuffled by ``SeedSequence([seed, epoch])``,
padded cyclically to ``sample_per_replica * num_replicas``, batches
permuted, a contiguous slice a rank) and in test mode (a strided slice of
the cyclically padded indices), for several replica counts, ranks, seeds
and epochs, and its shards must cover the epoch with one length a rank
(the reference's ``tests/test_multihost_train.py:53-64``).
``init_distributed`` does nothing in one process and raises, never
carrying on as one process, when ``WORLD_SIZE > 1`` cannot initialise or
NCCL would put two ranks on one GPU; the mesh refuses tensor parallelism
and spatial sharding by name.
"""

import socket

import numpy as np
import pytest
import torch

from torch_detection_tpu.data.sampler import DistributedGroupSampler as JaxDistributedGroupSampler
from torch_detection_tpu_torch.data import DistributedGroupSampler, build_dataloader
from torch_detection_tpu_torch.parallel import (
    batch_normaliser,
    global_rows,
    init_distributed,
    make_mesh,
    shard_batch,
    spatial_sharding,
    world_size,
)

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class _Dataset:
    """Aspect groups ``flag`` (or a test-mode dataset of ``len(flag)``)."""

    def __init__(self, flag, test_mode=False):
        self.flag = np.asarray(flag, np.uint8)
        self.test_mode = test_mode

    def __len__(self):
        return len(self.flag)


FLAGS = {"one_group": [0] * 8, "two_groups": [0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0],
         "uneven": [1] * 13 + [0] * 3, "empty_group": [2, 2, 0, 2, 0, 2, 2]}


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("replicas,per_replica", [(2, 2), (3, 1), (4, 2), (2, 4)])
def test_train_shards_are_the_reference_s(flags, replicas, per_replica):
    ds = _Dataset(FLAGS[flags])
    seen = []
    for seed in (0, 11):
        for rank in range(replicas):
            got = DistributedGroupSampler(ds, per_replica, replicas, rank, seed=seed)
            want = JaxDistributedGroupSampler(ds, per_replica, replicas, rank, seed=seed)
            assert len(got) == len(want)
            for epoch in (0, 1, 5):
                got.set_epoch(epoch)
                want.set_epoch(epoch)
                assert list(got) == list(want), (seed, rank, epoch)
            if seed == 0:
                seen.append(list(got))
    # one length a rank, the union every index; each batch holds one aspect group
    assert len({len(s) for s in seen}) == 1
    assert set().union(*seen) == set(range(len(ds)))
    for s in seen:
        batches = np.asarray(s).reshape(-1, per_replica)
        assert all(len(set(ds.flag[b])) == 1 for b in batches)


@pytest.mark.parametrize("n,replicas", [(7, 2), (8, 2), (10, 3), (3, 4)])
def test_test_mode_shards_are_the_reference_s(n, replicas):
    ds = _Dataset([0] * n, test_mode=True)
    shards = []
    for rank in range(replicas):
        got = list(DistributedGroupSampler(ds, 1, replicas, rank))
        assert got == list(JaxDistributedGroupSampler(ds, 1, replicas, rank))
        shards.append(got)
    assert set().union(*shards) == set(range(n))
    assert [i for s in zip(*shards) for i in s][:n] == list(range(n))  # the eval order


def test_a_distributed_loader_yields_its_rank_s_shard():
    ds = _Dataset(FLAGS["two_groups"])
    loader = build_dataloader(ds, sample_per_replica=2, dist=True, num_replicas=2, rank=1,
                              seed=3, collate_fn=list)
    assert isinstance(loader.sampler, DistributedGroupSampler)
    assert list(loader.sampler) == list(JaxDistributedGroupSampler(ds, 2, 2, 1, seed=3))
    assert len(loader) == len(loader.sampler) // 2


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_init_distributed_is_a_no_op_in_one_process(clean_env):
    info = init_distributed(device="cpu")
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert info["local_devices"] == info["global_devices"] == [torch.device("cpu")]
    assert not info["initialized"] and world_size() == 1
    clean_env.setenv("WORLD_SIZE", "1")
    assert init_distributed(device="cpu")["process_count"] == 1


def test_init_distributed_raises_when_the_group_cannot_form(clean_env):
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        init_distributed(device="cpu")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        clean_env.setenv(k, v)
    with pytest.raises(Exception, match="[Tt]imed out"):  # rank 1 never joins
        init_distributed(device="cpu", timeout_s=1.0)
    assert world_size() == 1


def test_nccl_refuses_two_ranks_on_one_gpu(clean_env):
    for k, v in dict(WORLD_SIZE="2", RANK="1", LOCAL_RANK="1", LOCAL_WORLD_SIZE="2",
                     MASTER_ADDR="localhost", MASTER_PORT="1").items():
        clean_env.setenv(k, v)
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    clean_env.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="two ranks on one device"):
        init_distributed(backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        init_distributed(backend="nccl", device="cpu")


def test_the_mesh_refuses_tensor_parallelism_and_spatial_sharding():
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        make_mesh(model=2)
    with pytest.raises(NotImplementedError, match="spatial_sharding"):
        spatial_sharding(None)
    with pytest.raises(NotImplementedError, match="spatial_sharding"):
        shard_batch(None, {}, spatial=True)
    batch = {"image": torch.zeros(1)}
    assert shard_batch(None, batch) is batch


def test_the_step_helpers_keep_one_process_as_it_was():
    """Outside a group, a step's normaliser is the plain clamp and its
    draws are the caller's."""
    def draw(shape):
        return (torch.rand(shape, generator=torch.Generator().manual_seed(0)),)

    for count in (torch.tensor(0.0), torch.tensor(7.0)):
        assert torch.equal(batch_normaliser(count), torch.clamp(count, min=1.0))
    assert global_rows(draw) is draw
    with pytest.raises(ValueError, match="gradient"):
        batch_normaliser(torch.tensor(2.0, requires_grad=True))
