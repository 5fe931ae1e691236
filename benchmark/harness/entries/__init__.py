"""The entries a traffic mix names (`"entry"` in its file): how a run drives
the program.  Each module here defines `Entry(config, traffic, seed,
device)`, whose constructor is the run's whole set-up (inputs drawn,
program built and warmed up on every shape the window uses), and:

  * `window(seconds)`: the timed window; returns the end-to-end readings
    by name, and `attempted` and `failed`;
  * `traced()`: a fixed amount of the same work, which the harness runs
    under the profiler; returns the units it ran (ticks, chunks, jobs);
  * `readings()`: what the per-layer readers may read besides the trace;
  * `release()`: frees the program's state once the window has closed;
  * `check(limits)`: the comparisons with the plain reference that
    decide `correct`, as `reference.compare.Check`s.

A new mix that drives an entry here is a data file in `benchmark/traffic/`
alone; a new way of driving the program is a new module here.
"""
