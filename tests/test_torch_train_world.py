"""The int8 collectives on their own: the rank body that
``tests/test_torch_train.py`` spawns on a gloo world, and checks of the
quantiser that need no reference.  The module imports torch and the port
only, so that spawned ranks import no JAX."""
import numpy as np
import torch

from repro_torch.launch.world import run_world
from repro_torch.parallel import collectives


def allreduce_rank(mesh, shards, errs):
    """``compressed_allreduce_mean`` of this rank's shard and error buffer
    over the world: ``(mean, new error)`` as numpy."""
    rank = torch.distributed.get_rank()
    mean, err = collectives.compressed_allreduce_mean(
        torch.as_tensor(shards[rank]), torch.as_tensor(errs[rank]))
    return mean.numpy(), err.numpy()


def test_int8_error_feedback_bounds_the_error():
    """The reference's own check on the port: int8 payload, the error of
    each element at most half a quantisation step."""
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(1000),
                        dtype=torch.float32)
    q, s = collectives.quantize_int8(x)
    err = x - collectives.dequantize_int8(q, s)
    assert q.dtype == torch.int8
    assert float(err.abs().max()) <= float(s) * 0.5 + 1e-6


def test_identical_shards_average_to_their_dequantised_value():
    """Every rank holding the same gradient: the mean is that gradient's
    int8 round trip, and each rank's new error is what the round trip
    lost."""
    g = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    shards = np.stack([g] * 2)
    errs = np.zeros_like(shards)
    ranks = run_world(allreduce_rank, 2, device_type="cpu",
                      args=(shards, errs), timeout_s=120)
    q, s = collectives.quantize_int8(torch.as_tensor(g))
    want = collectives.dequantize_int8(q, s).numpy()
    for mean, err in ranks:
        np.testing.assert_array_equal(mean, want)
        np.testing.assert_array_equal(err, g - want)
