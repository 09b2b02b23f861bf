"""Scheduler (L5) of the port: the kube-scheduler extender, gang
reservations and the slicefit box search. Host code: it imports numpy and
nothing of torch."""
