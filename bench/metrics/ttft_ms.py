"""The mean over all tasks completed in the window of the time from the
start of its batch to its first generated id on the host (host clock)."""


def read(rec):
    tasks = sum(b["batch"] for b in rec.batches)
    return 1e3 * sum(b["batch"] * (b["t_first"] - b["t_start"])
                     for b in rec.batches) / tasks
