"""The Gram wrapper's launch plan (``pairwise_sqdist.ops.launch_plan``), on
the CPU: which kernel runs for n, how wide its loads are for d and the data
pointer's alignment, and the chunks, at the shapes of the training paths
and of the card tests."""
import pytest

from repro_torch.kernels.pairwise_sqdist import ops as gram_ops

P_PHI4_DEPTH2 = 815_938_560                 # the protocol run's [4, P]
D_MLP_H1024 = 1_093_642                     # the single-host runs' [5, 7, D]


def _chunks_cover(plan, d):
    assert plan.chunk % gram_ops.TILE == 0
    assert (plan.n_chunks - 1) * plan.chunk < d <= plan.n_chunks * plan.chunk


@pytest.mark.parametrize("n", [1, 4, 7, 8, 9, 64])
@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_plan_by_n_and_width(n, r):
    """n <= 8 takes the register kernel with the widest load d allows
    (16 bytes when d % 4 == 0, 8 when d % 2 == 0, else 4); n > 8 the
    general kernel."""
    d = 3 * 4096 + 128 + r
    plan = gram_ops.launch_plan(3, n, d, 1 << 20)
    if n <= gram_ops.MAX_REG_N:
        assert plan.path == "register"
        assert plan.vec == {0: 4, 2: 2}.get(r, 1)
    else:
        assert (plan.path, plan.vec) == ("general", 1)
    assert (plan.chunk, plan.n_chunks) == gram_ops.chunking(3, d)
    _chunks_cover(plan, d)


@pytest.mark.parametrize("offset,vec", [(0, 4), (4, 1), (8, 2), (12, 1),
                                        (16, 4)])
def test_plan_follows_pointer_alignment(offset, vec):
    """A view that starts off a 16-byte boundary takes a narrower load."""
    assert gram_ops.launch_plan(1, 4, 8192, 256 + offset).vec == vec


def test_plan_at_the_training_shapes():
    """The protocol's [4, P] (P % 4 == 0) takes 16-byte loads over
    TARGET_BLOCKS chunks; mlp_h1024's [5, 7, D] (D = 2 mod 4) 8-byte
    loads."""
    plan = gram_ops.launch_plan(1, 4, P_PHI4_DEPTH2, 1 << 20)
    assert (plan.path, plan.vec) == ("register", 4)
    assert plan.n_chunks == gram_ops.TARGET_BLOCKS
    _chunks_cover(plan, P_PHI4_DEPTH2)
    plan = gram_ops.launch_plan(5, 7, D_MLP_H1024, 1 << 20)
    assert (plan.path, plan.vec) == ("register", 2)
    assert plan.n_chunks * 5 <= gram_ops.TARGET_BLOCKS + 5
    _chunks_cover(plan, D_MLP_H1024)

