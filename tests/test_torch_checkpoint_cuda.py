"""The checkpointer on the card: a CUDA generator's state saved and
restored (a resume draws what the saved run would have drawn next; a full
restore onto another device type is refused, a params-only one is not),
and a restore onto the card (the pool's leaves bit-equal, the consolidated
restore through the median kernel equal to the CPU's plain median). Imports
no JAX, so it runs on a machine with a GPU and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_checkpoint_cuda.py

Every test skips where CUDA is absent.
"""
import pytest
import torch

from _torch_parity import require_cuda
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.core import protocol
from repro_torch.core.simulator import FlatTree
from repro_torch.kernels.cwise_median import ops as median_ops
from repro_torch.serve import ReplicaPool

pytestmark = pytest.mark.cuda


def _state(dev, G=4, seed=3):
    tree = FlatTree([("b",), ("w",)], [(5,), (300, 40)])
    g = torch.Generator(device=dev).manual_seed(seed)
    params = torch.randn((G, tree.size), generator=g, device=dev)
    return protocol.ByzState(params=params, t=6, tree=tree,
                             gen=torch.Generator(device=dev).manual_seed(9))


def test_cuda_generator_state_round_trip(tmp_path):
    dev = require_cuda()
    s = _state(dev)
    torch.rand(11, generator=s.gen, device=dev)
    d = str(tmp_path)
    ck.save(d, 6, s)
    assert ck.read_manifest(d, 6)["leaves"][".gen"]["shape"] == [
        s.gen.get_state().numel()]
    back, step = ck.restore(d, 6, s, dev)
    assert step == 6 and back.t == 6 and back.gen.device.type == "cuda"
    assert torch.equal(back.params, s.params)
    assert torch.equal(torch.rand(7, generator=back.gen, device=dev),
                       torch.rand(7, generator=s.gen, device=dev))
    with pytest.raises(ValueError, match="another device type"):
        ck.restore(d, 6, s, "cpu")
    only, _ = ck.restore(d, 6, s, "cpu", params_only=True)
    assert torch.equal(only.params, s.params.cpu())


def test_restore_onto_the_card_and_consolidate(tmp_path):
    dev = require_cuda()
    s = _state("cpu", G=5)
    s.params[4] = 1e9
    d = str(tmp_path)
    ck.save(d, 6, s)
    pool = ReplicaPool.from_checkpoint(d, None, f=1, device=dev)
    for a, b in zip(s.tree.leaves(pool.params),
                    s.tree.leaves(s.tree.unflatten(s.params))):
        assert a.is_cuda and torch.equal(a.cpu(), b)
    template = protocol.ByzState(None, 0, None)
    before = median_ops.cwise_median.launches
    card, _ = ck.restore_consolidated(d, 6, template, dev)
    assert median_ops.cwise_median.launches > before
    cpu, _ = ck.restore_consolidated(d, 6, template, "cpu")
    assert card.params.is_cuda and torch.equal(card.params.cpu(), cpu.params)
    assert float(cpu.params.abs().max()) < 100.0
