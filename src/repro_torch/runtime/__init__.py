"""Runtime control-plane pieces (the port of ``repro.runtime``): the
trainer's heartbeat and straggler monitors, the failure-recovery policy,
and the clock-injected monitors the serving lifecycle and the ingestion
front end poll."""
