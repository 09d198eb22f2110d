"""The card's energy over the window (NVML's total-energy counter read
as the window opens and as it closes) per 1,000 tokens counted in
``task_tok_s``. None where the counter cannot be read."""


def read(rec):
    if rec.energy_j is None:
        return None
    return rec.energy_j / (rec.task_tokens() / 1e3)
