"""host_syncs_per_try: flags the step program copied to the host, per
try (Timestepper.stats host_syncs_step / tries; solver/program.py)."""


def read(run):
    tries = run["stats"].get("tries", 0)
    return run["stats"].get("host_syncs_step", 0) / tries if tries else None
