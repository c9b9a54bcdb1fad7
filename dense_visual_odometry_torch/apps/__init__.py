"""Command-line tools: ``benchmark`` (track a sequence, report ATE / RPE),
``evaluate`` (score a trajectory file against another) and ``make_dataset``
(render a synthetic TUM RGB-D directory)."""
