"""``join_roofline``: the join kernels (``csrc/segment_join.cu``,
``csrc/radix_pass.cuh``, ``kernels/segment_join``).

The least time the window's joins need, over the device time of the
kernels that performed them in the trace.  The least time counts, for each
answered query that joins, the bytes its join must move at the cell's
shapes (``portbench.roofline.join_bytes``: both sides' int64 keys read
once, one int32 build row written per probe row), over the H100's 3.35
TB/s: the same work whatever kernels carry it.  A query module names its
join's tables in ``JOIN``.  The device time is that of
the kernels named in :data:`KERNELS`: the radix pass that orders the build
side, the table build and the probe.  The sharded fragment joins in plain
PyTorch, so in its cells there is nothing to read.  It should move
``queries_per_s``.
"""
from portbench.roofline import join_bytes, least_seconds, roofline_pct

#: the join's kernels as the trace names them (a name matches when it
#: contains one of these): the build side's radix pass (its ``RankEnds``
#: instantiations, which the sort kernel's do not share), its scan, the
#: table build and the probe
KERNELS = ("radix::tile_hist_kernel<unsigned int, (anonymous namespace)::RankEnds>",
           "radix::column_scan_kernel<(anonymous namespace)::RankEnds>",
           "radix::digit_pass_kernel<unsigned int, (anonymous namespace)::RankEnds,",
           "(anonymous namespace)::exclusive_scan_kernel(",
           "(anonymous namespace)::join_table_build_kernel(",
           "(anonymous namespace)::join_table_probe_kernel<")


def read(run):
    if run.trace is None:
        return None
    least = 0.0
    for q in run.answered():
        join = getattr(run.modules[q.name], "JOIN", None)
        if join is not None:
            build, probe = join
            least += least_seconds(join_bytes(run.rows[build],
                                              run.rows[probe]))
    return roofline_pct(least, run.trace.kernel_time(KERNELS))
