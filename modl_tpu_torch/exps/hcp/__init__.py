"""The HCP pipeline: ``unmask_hcp`` writes raw ``.npy`` records and
their manifest, ``decompose_hcp`` streams them through ``fMRIDictFact``
at 1,024 components."""
