"""Serving runtimes of the port.

Counterpart of ``text_to_speech_tpu/runtimes/``, in part: `serving` (the
request engines and the Tacotron-2 and VITS steppers) and `http_server`
(`TTSServer`).  This module is a package marker only: the JAX package's
`Runtime` registry (``JAXRuntime``, ``ExportRuntime``, ``AOTRuntime``,
``HFRuntime``) waits for the port's export work (ROADMAP §1, queue 4, onto
``torch.export``), and ``llm_serving`` for queue 3.
"""
