"""Command-line tools: ``benchmark`` (track a sequence, report ATE / RPE),
``evaluate`` (score a trajectory file against another), ``make_dataset``
(render a synthetic TUM RGB-D directory), ``reconstruct`` (fuse a tracked
sequence into a TSDF volume and export a mesh), ``train_matcher`` (train the
LoFTR-lite matcher on rendered pairs) and ``visualize`` (a run's trajectory
figure, point cloud and replay)."""
