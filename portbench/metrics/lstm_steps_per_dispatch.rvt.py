"""The recurrent steps the network's LSTMs ran a dispatch, summed over
its LSTMs (``EventNetwork.layer_counts[...]["recurrent_steps"]``): one a
chunk a stream-batched scan, so 4 x 64 = 256 for RVT at 64 chunks a
dispatch.  Nothing where the program counts none."""


def read(rec):
    steps, dispatches = rec.counters.get("lstm_steps"), rec.counters.get("dispatches")
    return steps / dispatches if steps and dispatches else None
