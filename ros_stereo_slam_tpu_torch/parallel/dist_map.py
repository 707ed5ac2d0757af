"""The keyframe map sharded over the mesh (config 5).

Port of ``ros_stereo_slam_tpu/parallel/dist_map.py``.  The reference keeps
its whole map in host memory on one machine (``keyFrameHistory`` /
``mapHistory``, ``reference/include/visualSLAM.h:92-97``).  Here a
:class:`~..models.state.KeyframeStore`'s keyframe axis is split over the
ranks: rank d holds slots ``[d*K/D, (d+1)*K/D)``, so a rank's map memory
shrinks with the mesh and the map's capacity grows with it.

- insert: keyframe ``count`` lands in global slot ``count % K``; only the
  rank that owns the slot writes it, every rank advances ``count``
  (``step._insert_keyframe`` with a :class:`~..models.state.KeyframeShard`);
- post-PGO rewrite: each rank re-expresses its own blocks with the
  replicated (small) pose arrays, no collective
  (:func:`rewrite_points_sharded`);
- export: the store is gathered once (:func:`gather_keyframes`).
"""

from __future__ import annotations

from ros_stereo_slam_tpu_torch.models import pose_graph
from ros_stereo_slam_tpu_torch.models.state import KeyframeShard, KeyframeStore
from ros_stereo_slam_tpu_torch.parallel.mesh import Mesh, all_gather, shard_bounds


def keyframe_shardings(mesh: Mesh, capacity: int) -> KeyframeShard:
    """This rank's slots of a ring of `capacity` keyframes; raises
    ValueError when the mesh size does not divide it (pad
    ``KeyframeConfig.max_keyframes`` to a multiple of it)."""
    blk = shard_bounds(capacity, mesh, "keyframe capacity")
    return KeyframeShard(base=blk.start, capacity=capacity)


def shard_keyframes(mesh: Mesh, kf: KeyframeStore) -> KeyframeStore:
    """This rank's K/D slots of a whole store (copies: the whole store can
    be freed); ``count`` stays the global count."""
    blk = shard_bounds(kf.capacity, mesh, "keyframe capacity")
    return kf._replace(**{f: getattr(kf, f)[blk].clone() for f in kf._fields if f != "count"})


# The post-PGO rewrite of a rank's blocks needs no collective: with the
# (small) pose arrays replicated, each rank calls the single-device
# function on its own blocks, bitwise what the whole call gives them.
rewrite_points_sharded = pose_graph.rewrite_points


def gather_keyframes(mesh: Mesh, kf: KeyframeStore) -> KeyframeStore:
    """The whole store on every rank (a collective: every rank calls it)."""
    return kf._replace(**{f: all_gather(getattr(kf, f), mesh) for f in kf._fields
                          if f != "count"})
