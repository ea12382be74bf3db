"""The least time of the fused ``apgd_sc`` step's launches in the profiled
calls (``counts.sc_step_bytes`` at the card's HBM rate: bytes-bound) over
those launches' device time, in %.

Every launch runs the mix's whole batch.  A lane's live steps are its
reported matvecs (the operator brings its spectral bounds, so no matvec
comes before the loop), and a converged lane's last one verified; the
rest of the launches' lane-steps are on lanes already done.  A verifying
step that fails is counted as a plain one, one vector high.  None in a mix
with compaction (smaller batches in phase 2), in calls that stepped on
the eager body too, or where the trace's launches are not the program's
fused steps."""
from qpbench import counts

KERNEL = "apgd_sc_step"


def read(rec):
    peak = counts.peaks(rec.device_kind)
    if peak is None or rec.trace is None or "phase1" in rec.mix:
        return None
    names = [k for k in rec.trace.kernel_s if KERNEL in k]
    seconds = sum(rec.trace.kernel_s[k] for k in names)
    if seconds <= 0:
        return None
    launches = sum(rec.trace.kernel_launches[k] for k in names)
    steps = rec.profiled.counters or {}
    if steps.get("sc_steps_eager", 0) or steps.get("sc_steps_fused", launches) != launches:
        return None
    live = sum(int(m.sum()) for m in rec.profiled.matvecs)
    done = launches * int(rec.mix["lanes"]) - live
    if done < 0:
        return None
    moved = counts.sc_step_bytes(int(rec.config["n"]), live, done, rec.profiled.converged,
                                 rec.config["dtype"])
    return 100.0 * moved / peak["hbm_bytes_per_s"] / seconds
