"""Pure-Python ground truth for the BIP-352 scan pipeline: the port's own
copy of cudasp_tpu/oracle (that package imports JAX on any import, so the
port keeps these modules itself; tests pin them equal)."""
