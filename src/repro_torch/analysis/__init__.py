"""Host-side helpers the serving layer needs: only the lock factories of
:mod:`repro_torch.analysis.runtime` are carried over."""
