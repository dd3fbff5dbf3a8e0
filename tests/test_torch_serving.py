"""The port's sharded stream server (``parallel/serving.py``) on the CPU at
width 8, on ``test_torch_video.py``'s seeded SiamMask-sharp weights and
120x160 frames: replicas on one device named twice or four times (torch
has one CPU device), each in its own thread.

- over ``["cpu", "cpu"]`` at O=4 for 3 frames against the unsharded
  ``track_video_multi``, with ``tests/test_serving_sharded.py``'s
  tolerances (positions and scores rtol 1e-5 / atol 1e-4, masks 1e-4 /
  1e-3) and the same ``best_id``;
- ``init_batched`` with O not a multiple of the replicas raises;
- ``step`` is the first frame of ``track_video``;
- one open-loop step at O=8 against the JAX package's
  ``ShardedStreamServer.step`` on the 8-device CPU mesh, from the JAX
  server's own init, at ``test_torch_video.py``'s open-loop tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siammask_tpu.parallel.mesh import data_parallel_mesh
from siammask_tpu.parallel.serving import ShardedStreamServer as JaxShardedStreamServer
from siammask_tpu_torch.parallel.dist import local_rows
from siammask_tpu_torch.parallel.serving import ShardedStreamServer
from siammask_tpu_torch.tracker.tracker import StepOutput, TrackState

from test_torch_tracker import _frames, one_torch_thread  # noqa: F401  (autouse)
from test_torch_video import _to_port, trackers  # noqa: F401  (module fixture)

RNG = np.random.RandomState(23)
POS = RNG.uniform(40, 120, (8, 2)).astype(np.float32)
SZ = RNG.uniform(20, 60, (8, 2)).astype(np.float32)


def _shards(states: TrackState, n: int) -> list[TrackState]:
    o = states.target_pos.shape[0]
    return [TrackState(*(v[local_rows(o, i, n)] for v in states)) for i in range(n)]


@pytest.fixture(scope="module")
def video(trackers):
    """Sharded over two replicas and unsharded, O=4, 3 frames."""
    *_, tracker = trackers
    frames = _frames()
    server = ShardedStreamServer(tracker, ["cpu", "cpu"])
    states = server.init_batched(frames[0], POS[:4], SZ[:4])
    final, outs = server.track_video(states, frames[1:])
    ref_states = tracker.init_batched(frames[0], POS[:4], SZ[:4])
    ref_final, ref_outs = tracker.track_video_multi(ref_states, frames[1:])
    return server, states, final, outs, ref_final, ref_outs


def test_sharded_serving_matches_unsharded(video):
    server, states, final, outs, ref_final, ref_outs = video
    assert len(server.replicas) == len(states) == len(final) == 2
    assert [s.target_pos.shape[0] for s in states] == [2, 2]
    assert server.replicas[0].model is not server.replicas[1].model
    assert isinstance(outs, StepOutput) and outs.mask_in_frame.shape == (3, 4, 120, 160)
    np.testing.assert_array_equal(outs.best_id.numpy(), ref_outs.best_id.numpy())
    for name in ("target_pos", "score"):
        np.testing.assert_allclose(getattr(outs, name).numpy(), getattr(ref_outs, name).numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(outs.mask_in_frame.numpy(), ref_outs.mask_in_frame.numpy(),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(torch.cat([s.target_sz for s in final]).numpy(),
                               ref_final.target_sz.numpy(), rtol=1e-5, atol=1e-4)


def test_stream_count_must_tile_the_replicas(video):
    server = video[0]
    with pytest.raises(ValueError, match="multiple of"):
        server.init_batched(_frames()[0], POS[:3], SZ[:3])


def test_step_is_the_first_frame_of_track_video(video):
    server, states, _, outs, _, _ = video
    stepped, out = server.step(states, _frames()[1])
    for name, value in zip(StepOutput._fields, out):
        torch.testing.assert_close(value, getattr(outs, name)[0], rtol=0, atol=0, msg=name)
    assert [s.target_pos.shape[0] for s in stepped] == [2, 2]


def test_step_matches_jax_sharded_server_open_loop(trackers):
    """The JAX server inits 8 streams on its 8-device mesh and steps once;
    the port's server over four replicas steps from the same state."""
    jtracker, _, variables, tracker = trackers
    frames = _frames()
    jserver = JaxShardedStreamServer(jtracker, data_parallel_mesh())
    assert jserver.mesh.size == 8
    jstates = jserver.init_batched(variables, jnp.asarray(frames[0]), POS, SZ)
    _, ref = jserver.step(variables, jstates, jnp.asarray(frames[1]))
    server = ShardedStreamServer(tracker, ["cpu"] * 4)
    _, ours = server.step(_shards(_to_port(jstates), 4), frames[1])
    np.testing.assert_array_equal(ours.best_id.numpy(), np.asarray(ref.best_id))
    np.testing.assert_allclose(ours.target_pos.numpy(), np.asarray(ref.target_pos), atol=1e-3)
    np.testing.assert_allclose(ours.target_sz.numpy(), np.asarray(ref.target_sz), atol=1e-3)
    np.testing.assert_allclose(ours.score.numpy(), np.asarray(ref.score), atol=1e-5)
    np.testing.assert_allclose(ours.mask_logits.numpy(), np.asarray(ref.mask_logits), atol=1e-5)
    np.testing.assert_allclose(ours.mask_in_frame.numpy(), np.asarray(ref.mask_in_frame),
                               atol=1e-4)
