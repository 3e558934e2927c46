"""A frozen copy of the port's plain host frontend and fused chain.

Copied from grail_tpu_torch's text/, languages/ (the generic and English
rulesets), voices/ (the generic and plain voices), core/ and synth/
(score, schedule, jitter, sequencer, elem), with the imports kept relative
and every call into the port's native host library replaced by the Python
or numpy twin that the port keeps beside it (the transcriber automaton,
`_reference_boundary_samples_np`, `_np_simulate`), and synth/fused.py in
place of the kernels. It imports nothing of the port: the benchmark judges
the port's audio against it, so it must not move when the port does.
"""
