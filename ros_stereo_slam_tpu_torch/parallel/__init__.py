"""Multi-device layouts over ``torch.distributed`` (config 5): the mesh and
its collectives, landmark-sharded BA, edge- and chain-sharded PGO, the
sharded keyframe map, and a dry run of all of them
(``python -m ros_stereo_slam_tpu_torch.parallel.dryrun``)."""
