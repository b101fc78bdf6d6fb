"""Runtime control-plane pieces (the port of ``repro.runtime``): the
clock-injected monitors the serving lifecycle and the ingestion front end
poll.  The trainer's heartbeat, straggler and failure-recovery policies
come with the distributed-training slice."""
