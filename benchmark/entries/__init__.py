"""One module per entry of the port that a cell's traffic can drive,
found by the ``entry`` name in ``workloads/<cell>.json``. Each module has:

- ``CLI_ARGS``: arguments the CLI's parser gets after the cell's own;
- ``STREAMS_AT_ONCE``: True where one unit runs streams at once, which
  the harness then traces with one session of its own around the window;
- ``make_inputs(run)``: writes the cell's inputs (``Run.write_dsf`` or
  ``Run.write_raw_pool``);
- ``units_per_lap(run)``: the units of one lap of the album;
- ``unit(run, lap, i, keep)``: the i-th unit of a lap, timed from its
  call to its closed output, as a list of ``harness.Track``;
- ``warm(run)``: one short conversion through the same entry.
"""
