"""Library surfaces for embedding the debuggable scheduler
(reference simulator/pkg/debuggablescheduler)."""
