"""The program side of each configuration family: how the benchmark builds
the port's model from a configuration file, feeds it a traffic mix's
batches or requests, and reads what it produced. A configuration names its
family (``"family"``); ``families/<family>.py`` and
``reference/<family>.py`` are found by that name.

A family module gives:
- ``REFERENCE``, its plain reference module;
- ``Train(cfg, mix, weights, device)``: ``call(*args)`` runs one micro-step
  (the timed call; its loss comes back as a 0-d tensor), ``state`` is its
  ``TrainState``, ``model`` its module;
- ``train_batch(cfg, mix, seed, i)``: micro-step i's host arrays, in the
  order the reference's loss takes them; ``train_args(cfg, tensors, const)``
  the timed call's arguments from them on the device;
- ``Serve(cfg, mix, weights, device)``: ``answer(tensors)`` serves one
  request, its answer back on the host;
- ``serve_request(cfg, mix, seed, r)``: request r's host arrays;
- ``valid_counts(cfg, arrays)``: (nodes, pairs, graphs) of valid work;
- ``slots(cfg, mix)``: edge slots a micro-step (b * n * k * depth);
- ``answer_numbers(out, ref, arrays, detail)``: the numbers of one served
  answer against the reference's, each compared with its cell's limit.
"""
