"""Secure multi-party computation for encrypted inference.

Port of ``primia_tpu/mpc``: the fixed-point codec (``fixed``), additive
shares over Z_{2^64} (``shares``), exact ring products (``ring_ops``),
Beaver triples (``beaver``), the Threefry PRG (``prg``), the DCF
(``dcf``), the FSS comparison on kernel K4 (``compare``), SecureNN's
comparison, share conversion and division (``securenn``), the share-space
function library (``functions``), the share-space engine with private
batch and group norm and the RNN ops (``engine``), secure aggregation
(``aggregation``), encrypted inference (``inference``), share-space
autograd for encrypted training (``autograd``), PRZS zero shares
(``przs``), replicated 3-party sharing (``replicated``), Paillier
(``paillier``) and BFV (``bfv``). Import the submodules themselves: this
file imports none, so that the kernel's wrapper (``ops/cuda_dcf.py``),
which the comparison imports, can import ``mpc.dcf`` first.
"""
