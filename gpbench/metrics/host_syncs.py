"""host_syncs.<variant> (syncs per request): the program's counter
``host_syncs`` per traced request — the points where the port's own code
reads a tensor's value on the host, each a wait for the card (the answers'
host copies, the CG exit tests, the factor's info).  Each variant moves the
end-to-end metric of its own cell."""

from gpbench.harness import program_counters

COUNTERS = program_counters.named("host_syncs")


def read(ctx):
    return program_counters.per_request(ctx, "host_syncs")
