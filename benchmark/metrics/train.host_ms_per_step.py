"""train.host_ms_per_step: the host's time inside each ``Trainer.train_step``
call (a benchmark span, no synchronisation: the dispatch of one step), mean
over the window outside the traced slice, in ms."""


def read(name, rec):
    d = rec['spans'].get('train_step')
    return 1e3 * sum(d) / len(d) if d else None
