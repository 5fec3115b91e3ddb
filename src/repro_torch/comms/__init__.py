"""Model-exchange codecs (the comms tier): counterpart of `repro.comms`."""
