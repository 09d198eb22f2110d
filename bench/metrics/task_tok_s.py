"""Prompt plus generated tokens of every task completed in the window,
over the window's seconds (host clock): the edge server's throughput on
the mix."""


def read(rec):
    return rec.task_tokens() / rec.window_s
