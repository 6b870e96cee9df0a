"""Tools around the port's polisher (JAX package: racon_tpu/tools/;
reference: scripts/ and vendor/rampler).

``wrapper``    -- racon's wrapper (reference: scripts/racon_wrapper.py)
``rampler``    -- subsample and split (reference: vendor/rampler)
``preprocess`` -- Illumina pair renamer
                  (reference: scripts/racon_preprocess.py)

and the inputs the tests and chip_smoke.py build: ``simulate`` (ONT
sets with their PAF and truth), ``poa_windows``, ``band_pairs`` and
``wfa_pairs`` (constructed kernel inputs), ``contig_ladder`` (the align
ladder on a fragmented draft).
"""
