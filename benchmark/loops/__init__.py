"""One loop a kind of traffic: ``benchmark/loops/<kind>.py`` defines
``run(cfg, mix, seed, seconds, traced, device, t0, controls) -> Result``, and
a mix file names its loop by its ``kind``. A new kind is a new file here."""
