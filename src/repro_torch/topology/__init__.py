"""The program graph and the system graph of a job's placement: the
collectives of a lowered step (``traffic``, ``hlocost`` for HLO text)
and the hop distances of a torus of chips (``tpu``)."""
