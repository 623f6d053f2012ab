"""The generic parts of the benchmark: finding a cell's files by name
(`spec`), the card and the import guard (`device`), the measured window
(`window`) and the reading of the profiler's trace (`trace`)."""
